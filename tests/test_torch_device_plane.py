"""Parity of the port's device plane (``sparkrdma_tpu_torch.parallel.
device_plane``) with the JAX package's on the same numpy input: the cost
model's plans and errors over a grid of profiles, budgets, overrides and
topologies (the multi-slice scoring included), ``auto_rows_per_round``,
the double-buffered round driver (both key layouts, one shot and bounded
rounds, pipelined and sequential, empty input; its spans and overlap
instants; overflow) and the hierarchical driver (two slice layouts, the
cross-slice tally, a flat topology, per-slice degrade), and both drivers'
ring slots sized from each round's largest pair, so destination-grouped
rows (a committed map output's layout) overflow no pair. The port runs on
a CPU ``VirtualMesh`` with each of its transports; the JAX side on the
conftest's 8-device CPU mesh with ``gather`` and ``dense``."""

import itertools
import warnings

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from sparkrdma_tpu.parallel import device_plane as jdp
from sparkrdma_tpu.parallel import topology as jtopo
from sparkrdma_tpu.utils.trace import Tracer as JTracer
from sparkrdma_tpu_torch.parallel import device_plane as tdp
from sparkrdma_tpu_torch.parallel import topology as ttopo
from sparkrdma_tpu_torch.parallel.mesh import VirtualMesh
from sparkrdma_tpu_torch.utils import trace as ttrace

D = 8


@pytest.fixture(scope="module")
def mesh():
    return Mesh(np.array(jax.devices()[:D]), ("shuffle",))


@pytest.fixture(scope="module")
def vmesh():
    return VirtualMesh(D, "cpu")


# -- the cost model ----------------------------------------------------------

PROFILES = [dict(est_bytes=1 << 20, row_bytes=16),
            dict(est_bytes=1 << 30, row_bytes=16),
            dict(est_bytes=0, row_bytes=100),
            dict(est_bytes=-7, row_bytes=0),
            dict(est_bytes=1, row_bytes=16, resident=False),
            dict(est_bytes=5 << 20, row_bytes=24, out_factor=4),
            dict(est_bytes=1 << 20, row_bytes=16, intra_bytes=1 << 20,
                 inter_bytes=0),
            dict(est_bytes=1 << 20, row_bytes=16, intra_bytes=1 << 10,
                 inter_bytes=1 << 20)]
BUDGETS = [1, 95, 96, 1 << 20, 64 << 20]
OVERRIDES = ["auto", "device", "host", "hsot"]
TOPOLOGIES = [None, (8,), (4, 4), (2, 6), ((4, 4), 10.0, 10.0)]


def _topologies(spec):
    if spec is None:
        return None, None
    sizes, ici, dcn = spec if isinstance(spec[0], tuple) else (spec, 100.0,
                                                               10.0)
    return (ttopo.Topology(sizes, ici, dcn),
            jtopo.Topology(sizes, ici, dcn))


def _plan_or_error(fn):
    try:
        return fn()
    except ValueError as e:
        return ("ValueError", str(e))


@pytest.mark.parametrize("topo", TOPOLOGIES, ids=str)
@pytest.mark.parametrize("impl", ["auto", "dense", "gather"])
def test_select_dataplane_matches_jax(mesh, vmesh, topo, impl):
    t_topo, j_topo = _topologies(topo)
    for prof, budget, override, with_mesh in itertools.product(
            PROFILES, BUDGETS, OVERRIDES, (True, False)):
        got = _plan_or_error(lambda: tdp.select_dataplane(
            vmesh if with_mesh else None, tdp.StageProfile(**prof),
            impl=impl, hbm_budget=budget, override=override,
            topology=t_topo))
        want = _plan_or_error(lambda: jdp.select_dataplane(
            mesh if with_mesh else None, "shuffle", jdp.StageProfile(**prof),
            impl=impl, hbm_budget=budget, override=override,
            topology=j_topo))
        case = (prof, budget, override, with_mesh)
        if isinstance(want, tuple):
            assert got == want, case
            continue
        assert (got.plane, got.rows_per_round, got.reason) == (
            want.plane, want.rows_per_round, want.reason), case
        # "auto" resolves per package (gather on the CPU here, a probe in
        # JAX); an explicit transport and a hierarchical plan's raw ask
        # pass through
        if impl != "auto" or got.plane != "device":
            assert got.impl == want.impl, case
        assert (got.topology is t_topo) == (want.topology is j_topo) or (
            got.topology is None and want.topology is None), case


def test_plane_interface_matches_jax(mesh, vmesh):
    prof = tdp.StageProfile(est_bytes=1 << 20, row_bytes=16)
    jprof = jdp.StageProfile(est_bytes=1 << 20, row_bytes=16)
    off = tdp.StageProfile(est_bytes=1, row_bytes=16, resident=False)
    joff = jdp.StageProfile(est_bytes=1, row_bytes=16, resident=False)
    for tm, jm in ((vmesh, mesh), (None, None)):
        for tp, jp in ((prof, jprof), (off, joff)):
            assert tdp.DeviceExchange().supports(tm, tp) == \
                jdp.DeviceExchange().supports(jm, "shuffle", jp)
            assert tdp.HostExchange().supports(tm, tp) == \
                jdp.HostExchange().supports(jm, "shuffle", jp)
    assert tdp.HostExchange().plan(vmesh, prof) == tdp.ExchangePlan(
        "host", "", 0, "host dataplane")
    with pytest.raises(NotImplementedError):
        tdp.Exchange().supports(vmesh, prof)


@pytest.mark.parametrize("row_bytes", [0, 1, 16, 100, 4096])
@pytest.mark.parametrize("out_factor", [0, 1, 2, 4])
def test_auto_rows_per_round_matches_jax(row_bytes, out_factor):
    for budget in (0, 95, 96, 1 << 20, 64 << 20, -5):
        assert tdp.auto_rows_per_round(row_bytes, budget, out_factor) == \
            jdp.auto_rows_per_round(row_bytes, budget, out_factor)
    assert tdp.auto_rows_per_round(100, 64 << 20, 2) == 111848


def test_mesh_rows_deprecation_warns_once(monkeypatch):
    monkeypatch.setattr(tdp, "_rows_knob_warned", False)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        tdp.warn_mesh_rows_deprecated()
        tdp.warn_mesh_rows_deprecated("engine arg")
    assert [w.category for w in caught] == [DeprecationWarning]


# -- the round driver --------------------------------------------------------

def _rows(n_rows, key_words, seed, words=3):
    """u32[N, words] rows: a u32 key in column 0 or a packed u64 key in
    columns 0-1 whose low word collides often, and dest = key % D."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, 2**32, (n_rows, words), dtype=np.uint32)
    if key_words == 1:
        rows[:, 0] = rng.integers(0, 2**32, n_rows, dtype=np.uint32)
        keys = rows[:, 0].astype(np.uint64)
    else:
        rows[:, 0] = rng.integers(0, 4, n_rows, dtype=np.uint32)
        keys = rows[:, :2].copy().view(np.uint64).reshape(-1)
    return rows, (keys % D).astype(np.int32)


_JAX = {}


def _jax_fused(mesh, data_key, **kw):
    key = data_key + tuple(sorted(kw.items()))
    if key not in _JAX:
        _JAX[key] = jdp.run_fused_exchange(mesh, "shuffle",
                                           *_rows(*data_key), **kw)
    return _JAX[key]


@pytest.mark.parametrize("key_words", [1, 2])
@pytest.mark.parametrize("rows_per_round", [0, 128])
@pytest.mark.parametrize("pipeline", [True, False])
@pytest.mark.parametrize("port_impl,jax_impl", [("ring", "dense"),
                                                ("dense", "dense"),
                                                ("gather", "gather")])
def test_run_fused_exchange_matches_jax(mesh, vmesh, key_words,
                                        rows_per_round, pipeline, port_impl,
                                        jax_impl):
    key = (3000, key_words, 5)
    got, rounds = tdp.run_fused_exchange(
        vmesh, *_rows(*key), key_words=key_words,
        rows_per_round=rows_per_round, out_factor=4, impl=port_impl,
        pipeline_rounds=pipeline)
    want, want_rounds = _jax_fused(
        mesh, key, key_words=key_words,
        rows_per_round=rows_per_round, out_factor=4, impl=jax_impl)
    assert rounds == want_rounds == (1 if rows_per_round == 0
                                     else -(-3000 // (128 * D)))
    for d in range(D):
        assert got[d].dtype == want[d].dtype == np.uint32
        np.testing.assert_array_equal(got[d], want[d])


def test_run_fused_exchange_empty_and_single_row(mesh, vmesh):
    empty, rounds = tdp.run_fused_exchange(
        vmesh, np.zeros((0, 3), np.uint32), np.zeros(0, np.int32))
    want, want_rounds = jdp.run_fused_exchange(
        mesh, "shuffle", np.zeros((0, 3), np.uint32), np.zeros(0, np.int32))
    assert rounds == want_rounds == 0
    assert [e.shape for e in empty] == [w.shape for w in want]
    none, rounds = tdp.run_fused_exchange_rounds(vmesh, iter(()), 3, 16,
                                                 impl="gather")
    assert rounds == 0 and all(len(e) == 0 for e in none)
    one = np.array([[7, 0, 9]], np.uint32)
    got, rounds = tdp.run_fused_exchange(vmesh, one, np.array([5], np.int32),
                                         impl="gather")
    assert rounds == 1
    assert [len(g) for g in got] == [0, 0, 0, 0, 0, 1, 0, 0]
    np.testing.assert_array_equal(got[5], one)


def test_round_spans_and_overlap_instants(vmesh):
    """One exchange.round span per round; pipelined rounds leave rounds-1
    exchange.overlap instants, sequential ones none; same bytes."""
    rows, dest = _rows(4000, 2, 0)

    def run(pipeline):
        tracer = ttrace.Tracer()
        res, rounds = tdp.run_fused_exchange(
            vmesh, rows, dest, key_words=2, impl="ring", out_factor=4,
            rows_per_round=128, tracer=tracer, pipeline_rounds=pipeline)
        return (res, rounds, tracer.events("exchange.round"),
                tracer.events("exchange.overlap"), tracer)

    res_p, rounds, spans, overlaps, tracer = run(True)
    assert rounds == -(-4000 // (128 * D)) and rounds >= 3
    assert len(spans) == rounds
    assert len(overlaps) == rounds - 1
    assert [e["args"]["round"] for e in spans] == list(range(rounds))
    assert len(tracer.events("exchange.stage")) == rounds
    assert len(tracer.events("exchange.collect")) == rounds
    assert len(tracer.events("exchange.merge")) == 1
    res_s, _, spans_s, overlaps_s, _ = run(False)
    assert len(spans_s) == rounds and not overlaps_s
    for a, b in zip(res_p, res_s):
        np.testing.assert_array_equal(a, b)


def test_round_overflow_raises_in_both(mesh, vmesh):
    rows, _ = _rows(2000, 2, 1)
    dest = np.full(len(rows), 4, np.int32)   # every row to one shard
    with pytest.raises(OverflowError):
        tdp.run_fused_exchange(vmesh, rows, dest, out_factor=2,
                               impl="gather")
    with pytest.raises(OverflowError):
        jdp.run_fused_exchange(mesh, "shuffle", rows, dest, out_factor=2,
                               impl="gather")


def _by_destination(rows):
    """Rows spread evenly over the D shards and laid out as a committed
    map output lays them out, grouped by destination: a round's source
    shard sends all its rows to one or two destinations."""
    dest = (np.arange(len(rows)) % D).astype(np.int32)
    order = np.argsort(dest, kind="stable")
    return rows[order], dest[order]


@pytest.mark.parametrize("dest,cap,out_factor,want", [
    (np.tile(np.arange(D), 16), 16, 2, 4),        # even pairs: the share
    (np.repeat(np.arange(D), 16), 16, 2, 16),     # one destination each
    ([0] * 5 + [1] * 4 + [2] * 4 + [3] * 3, 16, 2, 8),   # 5, a power of 2
    ([-1] * 16 + [D] * 16, 16, 2, 4),             # padding is not sent
    ([3] * 20, 16, 2, 16),                        # a short last shard
    ([6] * 12, 12, 2, 12),                        # held to one shard's rows
    ([1] * 12, 12, 8, 12),                        # the share already fits
], ids=["even", "contiguous", "bucketed", "padding", "short", "capped",
        "fits"])
def test_slot_rows_fit_the_largest_pair(dest, cap, out_factor, want):
    assert tdp._slot_rows(np.asarray(dest, np.int32), D, cap,
                          out_factor) == want


@pytest.mark.parametrize("rows_per_round", [0, 128])
@pytest.mark.parametrize("port_impl", ["ring", "dense"])
def test_round_slots_fit_destination_grouped_rows(mesh, vmesh, port_impl,
                                                  rows_per_round):
    """Destination-grouped rows put a pair past the even slot share
    ``cap * out_factor // D``, where the fused step's fixed slots flag an
    overflow; the round driver sizes each round's slots from its largest
    pair, so no round overflows and the result equals the JAX package's
    ragged (``gather``) result."""
    rows, dest = _by_destination(_rows(3000, 2, 8)[0])
    cap = rows_per_round or -(-len(rows) // D)
    step = tdp.make_fused_step(vmesh, out_factor=4, impl=port_impl,
                               key_words=2, partition="dest")
    block = torch.from_numpy(rows[:cap * D].view(np.int32)).reshape(
        D, cap, 3)
    dblock = torch.from_numpy(dest[:cap * D]).reshape(D, cap)
    assert step(block, dblock)[2].any()
    assert not step(block, dblock, tdp._slot_rows(
        dest[:cap * D], D, cap, 4))[2].any()
    tracer = ttrace.Tracer()
    got, rounds = tdp.run_fused_exchange(
        vmesh, rows, dest, key_words=2, rows_per_round=rows_per_round,
        out_factor=4, impl=port_impl, tracer=tracer)
    want, want_rounds = jdp.run_fused_exchange(
        mesh, "shuffle", rows, dest, key_words=2,
        rows_per_round=rows_per_round, out_factor=4, impl="gather")
    assert rounds == want_rounds
    slots = [e["args"]["slot_rows"] for e in tracer.events("exchange.round")]
    assert len(slots) == rounds and max(slots) > cap * 4 // D
    for d in range(D):
        np.testing.assert_array_equal(got[d], want[d])


def test_stage_to_device_on_the_cpu_aliases(vmesh):
    arr = np.arange(48, dtype=np.uint32).reshape(16, 3)
    staged = tdp.stage_to_device(arr, vmesh)
    assert staged.shape == (D, 2, 3) and staged.dtype == torch.int32
    arr[0, 0] = 99
    assert int(staged[0, 0, 0]) == 99   # the same bytes, no copy
    with pytest.raises(ValueError, match="do not split"):
        tdp.stage_to_device(arr[:15], vmesh)


# -- the hierarchical driver -------------------------------------------------

def _slice_rows(n_rows, sizes, seed):
    rows, dest = _rows(n_rows, 2, seed)
    rng = np.random.default_rng(seed + 1)
    home = rng.integers(0, len(sizes), n_rows).astype(np.int32)
    return rows, dest, home


@pytest.mark.parametrize("sizes", [(4, 4), (2, 6)], ids=str)
@pytest.mark.parametrize("rows_per_round", [0, 128])
def test_hierarchical_matches_jax(mesh, vmesh, sizes, rows_per_round):
    rows, dest, home = _slice_rows(3000, sizes, 11)
    before = ttopo.cross_slice_snapshot()
    got, rounds = tdp.run_hierarchical_exchange(
        vmesh, ttopo.Topology(sizes), rows, dest, home, key_words=2,
        out_factor=8, impl="ring", rows_per_round=rows_per_round)
    moved = {k: ttopo.cross_slice_snapshot()[k] - before[k]
             for k in before}
    jbefore = jtopo.cross_slice_snapshot()
    want, want_rounds = jdp.run_hierarchical_exchange(
        mesh, "shuffle", jtopo.Topology(sizes), rows, dest, home,
        key_words=2, out_factor=8, impl="gather",
        rows_per_round=rows_per_round)
    jmoved = {k: jtopo.cross_slice_snapshot()[k] - jbefore[k]
              for k in jbefore}
    assert rounds == want_rounds
    assert moved == jmoved
    dev_slice = np.repeat(np.arange(len(sizes)), sizes)
    assert moved["bytes"] == int((dev_slice[dest] != home).sum()) * 12
    flat, _ = tdp.run_fused_exchange(vmesh, rows, dest, key_words=2,
                                     out_factor=8, impl="gather")
    for d in range(D):
        np.testing.assert_array_equal(got[d], want[d])
        np.testing.assert_array_equal(got[d], flat[d])


def test_hierarchical_flat_topology_is_the_flat_driver(vmesh):
    rows, dest, home = _slice_rows(1500, (8,), 3)
    before = ttopo.cross_slice_snapshot()
    got, rounds = tdp.run_hierarchical_exchange(
        vmesh, ttopo.Topology((8,)), rows, dest, home, impl="ring",
        rows_per_round=100, out_factor=4)
    assert ttopo.cross_slice_snapshot() == before
    flat, flat_rounds = tdp.run_fused_exchange(vmesh, rows, dest,
                                               impl="ring",
                                               rows_per_round=100,
                                               out_factor=4)
    assert rounds == flat_rounds == 2
    for a, b in zip(got, flat):
        np.testing.assert_array_equal(a, b)
    empty, rounds = tdp.run_hierarchical_exchange(
        vmesh, ttopo.Topology((4, 4)), np.zeros((0, 3), np.uint32),
        np.zeros(0, np.int32), np.zeros(0, np.int32), impl="gather")
    assert rounds == 0 and all(len(e) == 0 for e in empty)


def test_hierarchical_slots_fit_destination_grouped_rows(mesh, vmesh):
    """The two-level driver sizes each slice round's slots as the flat
    one does: destination-grouped rows degrade no slice on the ring and
    equal the JAX package's ``gather`` result."""
    rows, _, home = _slice_rows(3000, (4, 4), 12)
    dest = (np.arange(len(rows)) % D).astype(np.int32)
    order = np.lexsort((dest, home))
    rows, dest, home = rows[order], dest[order], home[order]
    tracer = ttrace.Tracer()
    got, rounds = tdp.run_hierarchical_exchange(
        vmesh, ttopo.Topology((4, 4)), rows, dest, home, key_words=2,
        out_factor=2, impl="ring", rows_per_round=128, tracer=tracer)
    assert tracer.events("exchange.degrade") == []
    assert max(e["args"]["slot_rows"]
               for e in tracer.events("exchange.round")) > 128 * 2 // 4
    want, want_rounds = jdp.run_hierarchical_exchange(
        mesh, "shuffle", jtopo.Topology((4, 4)), rows, dest, home,
        key_words=2, out_factor=2, impl="gather", rows_per_round=128)
    assert rounds == want_rounds
    for d in range(D):
        np.testing.assert_array_equal(got[d], want[d])


def test_slice_overflow_degrades_only_that_slice(mesh, vmesh):
    """Slice 1's rows all land on shard 4, past the out_factor headroom:
    only slice 1 degrades to host serving (one exchange.degrade instant
    with scope "slice"), with the JAX package's bytes."""
    r0, _ = _rows(2000, 2, 20)
    k0 = r0[:, :2].copy().view(np.uint64).reshape(-1)
    r1, _ = _rows(2000, 2, 21)
    rows = np.concatenate([r0, r1])
    dest = np.concatenate([(k0 % 4).astype(np.int32),
                           np.full(len(r1), 4, np.int32)])
    home = np.repeat(np.array([0, 1], np.int32), 2000)
    tracer = ttrace.Tracer()
    got, _ = tdp.run_hierarchical_exchange(
        vmesh, ttopo.Topology((4, 4)), rows, dest, home, key_words=2,
        out_factor=2, impl="ring", tracer=tracer)
    degrades = tracer.events("exchange.degrade")
    assert [(e["args"]["slice"], e["args"]["scope"]) for e in degrades] == [
        (1, "slice")]
    jtracer = JTracer()
    want, _ = jdp.run_hierarchical_exchange(
        mesh, "shuffle", jtopo.Topology((4, 4)), rows, dest, home,
        key_words=2, out_factor=2, impl="gather", tracer=jtracer)
    assert [e["args"]["slice"] for e in jtracer._events
            if e["name"] == "exchange.degrade"] == [1]
    for d in range(D):
        np.testing.assert_array_equal(got[d], want[d])


# -- the tracer --------------------------------------------------------------

def test_tracer_matches_jax_events_and_profiles_on_the_cpu(tmp_path,
                                                           vmesh):
    """The port's tracer records the JAX tracer's event shapes (a span, an
    instant, a counter, an explicit span; the null tracer nothing), and
    ``device_profile`` writes a Chrome trace holding a driver's
    ``record_function`` spans."""
    import json

    def drive(tracer):
        with tracer.span("exchange.round", "exchange", round=0):
            tracer.instant("exchange.overlap", "exchange", dispatched=1)
        tracer.counter("retries", 3.0)
        t0 = tracer.now_us()
        tracer.complete_span("fetch.wire", "fetch", t0, t0 + 5.0, n=2)
        return [{k: v for k, v in e.items() if k not in ("ts", "dur", "pid",
                                                          "tid")}
                for e in tracer._events]

    assert drive(ttrace.Tracer()) == drive(JTracer())
    assert drive(ttrace.NULL) == [] and ttrace.get(None) is ttrace.NULL
    conf = type("Conf", (), {"trace_file": "t.json"})()
    assert ttrace.get(conf).enabled
    tracer = ttrace.Tracer()
    drive(tracer)
    assert tracer.dump(str(tmp_path / "t.json")) == 4
    meta = json.loads((tmp_path / "t.json").read_text())["traceEvents"][0]
    assert meta["args"]["name"] == "sparkrdma_tpu_torch"

    rows, dest = _rows(600, 2, 4)
    with ttrace.device_profile(str(tmp_path / "prof")) as prof:
        tdp.run_fused_exchange(vmesh, rows, dest, impl="ring",
                               rows_per_round=40, out_factor=4)
    names = {e.key for e in prof.key_averages()}
    assert {"exchange.round", "exchange.stage", "exchange.receive_fill",
            "exchange.transport"} <= names
    written = list((tmp_path / "prof").glob("trace_*.json"))
    assert len(written) == 1
    assert "exchange.round" in written[0].read_text()
