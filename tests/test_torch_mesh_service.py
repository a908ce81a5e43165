"""Parity of the port's mesh shuffle service
(``sparkrdma_tpu_torch.shuffle.mesh_service``) and its on-ramp
(``shuffle.reader.read_to_device``) with the JAX package's.

Both packages reduce the SAME committed map outputs: the JAX package's
managers (a driver plus two executors, as ``tests/test_mesh_service.py``
builds them) and the same handle, since the mesh service reads only each
manager's ``resolver`` and a few handle fields. The JAX side runs on the
conftest's 8-device CPU mesh; the port on ``VirtualMesh(8, "cpu")`` with
the ring transport (the kernel's plain twin on the CPU) and ``gather``.
Per-shard ``(keys, payload, partition_ids)`` compare byte for byte;
``read_to_device`` compares as a multiset of records, since JAX's order
is a fetch order. Also: the edges (empty shuffle, overflow, a missing,
duplicate or corrupt map), the port's own managers against the JAX
resolver's bytes, ``slice_aligned_partition_map``, and the
host-plane names the service uses (``decode_rows``, ``PartitionerSpec``,
the errors)."""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from sparkrdma_tpu.config import TpuShuffleConf
from sparkrdma_tpu.parallel import topology as jtopo
from sparkrdma_tpu.shuffle import fetcher as jfetcher
from sparkrdma_tpu.shuffle import mesh_service as jms
from sparkrdma_tpu.shuffle import planner as jplanner
from sparkrdma_tpu.shuffle import writer as jwriter
from sparkrdma_tpu.shuffle.manager import PartitionerSpec, TpuShuffleManager
from sparkrdma_tpu.utils import integrity as jintegrity
from sparkrdma_tpu_torch.config import TpuShuffleConf as TConf
from sparkrdma_tpu_torch.parallel import topology as ttopo
from sparkrdma_tpu_torch.parallel.mesh import VirtualMesh
from sparkrdma_tpu_torch.shuffle import fetcher as tfetcher
from sparkrdma_tpu_torch.shuffle import manager as tmanager
from sparkrdma_tpu_torch.shuffle import mesh_service as tms
from sparkrdma_tpu_torch.shuffle import planner as tplanner
from sparkrdma_tpu_torch.shuffle import writer as twriter
from sparkrdma_tpu_torch.shuffle.reader import read_to_device
from sparkrdma_tpu_torch.utils import integrity as tintegrity
from sparkrdma_tpu_torch.utils.trace import Tracer

D = 8
P = 16
MAPS = 4
ROWS_PER_MAP = 700
CONF = TpuShuffleConf(connect_timeout_ms=5000)
# partitioner kind -> (shuffle id, payload bytes): 8 is whole words, 5 and
# 12 exercise the padded last word and a wider row
KINDS = {"modulo": (101, 8), "hash": (102, 5), "range": (103, 12)}
VARIANTS = ("one_shot", "fused_one_shot", "fused_rounds", "streamed",
            "streamed_sequential", "hier")


@pytest.fixture(scope="module")
def mesh():
    return Mesh(np.array(jax.devices()[:D]), ("shuffle",))


@pytest.fixture(scope="module")
def vmesh():
    return VirtualMesh(D, "cpu")


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_service")
    driver = TpuShuffleManager(CONF, is_driver=True)
    execs = [TpuShuffleManager(CONF, driver_addr=driver.driver_addr,
                               executor_id=str(i),
                               spill_dir=str(tmp / f"e{i}"))
             for i in range(2)]
    for ex in execs:
        ex.executor.wait_for_members(2)
    yield driver, execs
    for ex in execs:
        ex.stop()
    driver.stop()


def _map_input(kind: str, m: int, width: int):
    rng = np.random.default_rng(1000 * width + m)
    if kind == "hash":
        keys = rng.integers(0, 2**64, ROWS_PER_MAP, dtype=np.uint64)
    else:  # small key ranges: duplicate keys test the tie order
        keys = rng.integers(0, 900, ROWS_PER_MAP).astype(np.uint64)
    payload = rng.integers(0, 256, (ROWS_PER_MAP, width), dtype=np.uint8)
    return keys, payload


def _spec(kind: str) -> PartitionerSpec:
    if kind == "range":
        # even ranges over the keys 0..899: no partition outgrows its slot
        return PartitionerSpec("range", tuple(range(56, 900, 56))[:P - 1])
    return PartitionerSpec(kind)


def _write(driver, execs, shuffle_id, spec, width, inputs, holders):
    handle = driver.register_shuffle(shuffle_id, num_maps=len(inputs),
                                     num_partitions=P, partitioner=spec,
                                     row_payload_bytes=width)
    for m, (keys, payload) in enumerate(inputs):
        for e in holders(m):
            w = execs[e].get_writer(handle, m)
            w.write_batch(keys, payload)
            w.close()
    return handle


@pytest.fixture(scope="module")
def shuffles(cluster):
    """kind -> (handle, per-map inputs), committed once on the cluster."""
    driver, execs = cluster
    out = {}
    for kind, (sid, width) in KINDS.items():
        inputs = [_map_input(kind, m, width) for m in range(MAPS)]
        handle = _write(driver, execs, sid, _spec(kind), width, inputs,
                        lambda m: [m % 2])
        out[kind] = (handle, inputs)
    return out


def _run(pkg: str, variant: str, execs, handle, mesh, **kw):
    """One reduce of ``variant`` through package ``pkg``; ``mesh`` is the
    JAX mesh or the port's ``VirtualMesh``.

    A committed output is partition-contiguous, so a small round's shard
    holds a few whole partitions and one (source, destination) pair can
    carry all of its rows; the round variants get the headroom of
    ``out_factor = D`` unless the caller sets one, so the streamed
    reduce's fixed pair slots (``out_cap // D`` rows) hold every pair
    (the fused driver sizes its slots from each round's pairs)."""
    ms = jms if pkg == "jax" else tms
    if variant in ("fused_rounds", "streamed", "streamed_sequential"):
        kw.setdefault("out_factor", D)
    if variant == "one_shot":
        return ms.run_mesh_reduce(execs, handle, mesh, **kw)
    if variant == "fused_one_shot":
        return ms.run_mesh_reduce_fused(execs, handle, mesh, **kw)
    if variant == "fused_rounds":
        return ms.run_mesh_reduce_fused(execs, handle, mesh,
                                        rows_per_round=150, **kw)
    if variant.startswith("streamed"):
        return ms.run_mesh_reduce_streamed(
            execs, handle, mesh, rows_per_round=128,
            pipeline_rounds=variant == "streamed", **kw)
    topo = (jtopo if pkg == "jax" else ttopo).Topology((4, 4))
    return ms.run_mesh_reduce_hier(execs, handle, mesh, topo, **kw)


def _assert_same(got, want, what=""):
    assert len(got) == len(want) == D
    for d in range(D):
        for name, a, b in zip(("keys", "payload", "parts"), got[d],
                              want[d]):
            assert a.dtype == b.dtype, (what, d, name)
            np.testing.assert_array_equal(a, b, err_msg=f"{what} shard "
                                          f"{d} {name}")


@pytest.fixture(scope="module")
def jax_results():
    return {}


def _jax_result(jax_results, kind, variant, execs, handle, mesh):
    if (kind, variant) not in jax_results:
        jax_results[kind, variant] = _run("jax", variant, execs, handle,
                                          mesh, expect_maps=MAPS)
    return jax_results[kind, variant]


@pytest.mark.parametrize("impl", ["ring", "gather", "native"])
@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("kind", list(KINDS))
def test_reduce_matches_jax(cluster, shuffles, mesh, vmesh, jax_results,
                            kind, variant, impl):
    _, execs = cluster
    handle, inputs = shuffles[kind]
    want = _jax_result(jax_results, kind, variant, execs, handle, mesh)
    got = _run("port", variant, execs, handle, vmesh, impl=impl,
               expect_maps=MAPS)
    _assert_same(got, want, f"{kind}/{variant}/{impl}")
    assert sum(len(k) for k, _, _ in got) == MAPS * ROWS_PER_MAP
    if variant != "hier":  # the flat placement: partition p on shard p % D
        for d, (_, _, parts) in enumerate(got):
            assert (parts % D == d).all()


def test_streamed_native_needs_no_pair_headroom(cluster, shuffles, mesh,
                                               vmesh, jax_results):
    """The streamed reduce's ``out_factor = D`` headroom is for the ring's
    fixed pair slots: at ``out_factor = 2`` the ring overflows a slot of
    a partition-contiguous round, while ``native`` (no slots) and
    ``gather`` give the JAX package's bytes."""
    _, execs = cluster
    handle, _ = shuffles["hash"]
    want = _jax_result(jax_results, "hash", "streamed", execs, handle, mesh)
    for impl in ("native", "gather"):
        got = _run("port", "streamed", execs, handle, vmesh, impl=impl,
                   out_factor=2, expect_maps=MAPS)
        _assert_same(got, want, impl)
    with pytest.raises(OverflowError, match="receive overflow"):
        _run("port", "streamed", execs, handle, vmesh, impl="ring",
             out_factor=2, expect_maps=MAPS)


def _first_per_key(keys, payload):
    """A combiner for ``read_aggregated``: the first row of each key."""
    starts = np.flatnonzero(np.r_[True, keys[1:] != keys[:-1]])
    return keys[starts], payload[starts]


@pytest.mark.parametrize("kind", list(KINDS))
def test_split_and_cached_reader_match_jax(cluster, shuffles, mesh, vmesh,
                                           jax_results, kind):
    _, execs = cluster
    handle, _ = shuffles[kind]
    width = handle.row_payload_bytes
    jres = _jax_result(jax_results, kind, "fused_rounds", execs, handle,
                       mesh)
    tres = _run("port", "fused_rounds", execs, handle, vmesh, impl="ring")
    jper = jms.split_by_partition(jres, P, width)
    tper = tms.split_by_partition(tres, P, width)
    assert len(tper) == P
    for (tk, tp), (jk, jp) in zip(tper, jper):
        np.testing.assert_array_equal(tk, jk)
        np.testing.assert_array_equal(tp, jp)
    for lo, hi in ((0, P), (3, 9), (5, 5), (P - 1, P)):
        readers = [mod.CachedPartitionReader(per, lo, hi, width)
                   for mod, per in ((tms, tper), (jms, jper))]
        batches = [list(r.read()) for r in readers]
        assert len(batches[0]) == len(batches[1])
        for (tk, tp), (jk, jp) in zip(*batches):
            np.testing.assert_array_equal(tk, jk)
            np.testing.assert_array_equal(tp, jp)
        for method in ("read_all", "read_sorted"):
            for a, b in zip(*(getattr(r, method)() for r in readers)):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
        for a, b in zip(*(r.read_aggregated(_first_per_key)
                          for r in readers)):
            np.testing.assert_array_equal(a, b)
        spilled = [list(r.read_sorted_spilled()) for r in readers]
        assert len(spilled[0]) == len(spilled[1])
        for (tk, tp), (jk, jp) in zip(*spilled):
            np.testing.assert_array_equal(tk, jk)
            np.testing.assert_array_equal(tp, jp)
        t_metrics, j_metrics = (r.metrics for r in readers)
        assert t_metrics.local_bytes == j_metrics.local_bytes
        assert t_metrics.local_fetches == j_metrics.local_fetches
        assert t_metrics.remote_bytes == j_metrics.remote_bytes == 0


def test_fused_reduce_traces_its_host_staging(cluster, shuffles, vmesh):
    """The fused reduces record staging, packing, partitioning and
    unpacking beside the round driver's spans; the result is the same
    with and without a tracer."""
    _, execs = cluster
    handle, _ = shuffles["hash"]
    tracer = Tracer()
    kw = dict(impl="ring", rows_per_round=150, out_factor=D)
    traced = tms.run_mesh_reduce_fused(execs, handle, vmesh, tracer=tracer,
                                       **kw)
    _assert_same(traced, tms.run_mesh_reduce_fused(execs, handle, vmesh,
                                                   **kw))
    # one decode per committed output, plus the exhausted read
    assert len(tracer.events("mesh.decode")) == MAPS + 1
    for name in ("mesh.pack", "mesh.partition"):
        assert len(tracer.events(name)) == MAPS
    assert len(tracer.events("mesh.unpack")) == 1
    assert len(tracer.events("exchange.round")) >= 2


@pytest.fixture(scope="module")
def port_cluster(tmp_path_factory):
    """The port's own driver and two executors, for the module."""
    tmp = tmp_path_factory.mktemp("mesh_service_port")
    conf = TConf(connect_timeout_ms=5000)
    driver = tmanager.TpuShuffleManager(conf, is_driver=True)
    execs = []
    try:
        execs = [tmanager.TpuShuffleManager(
            conf, driver_addr=driver.driver_addr, executor_id=str(i),
            spill_dir=str(tmp / f"e{i}")) for i in range(2)]
        for ex in execs:
            ex.executor.wait_for_members(2)
        yield driver, execs
    finally:
        for ex in execs:
            ex.stop()
        driver.stop()


def test_port_managers_serve_the_resolver_bytes(cluster, shuffles,
                                                port_cluster, vmesh):
    """The same map outputs written through the port's own writers lay
    out byte for byte as the JAX writer and resolver lay them out, and a
    reduce staged from the port's managers equals the reduce staged from
    the JAX managers."""
    _, execs = cluster
    tdriver, texecs = port_cluster
    for kind, (handle, inputs) in shuffles.items():
        spec = tmanager.PartitionerSpec(handle.partitioner.kind,
                                        handle.partitioner.splitters)
        port_handle = tdriver.register_shuffle(
            handle.shuffle_id, num_maps=len(inputs), num_partitions=P,
            partitioner=spec, row_payload_bytes=handle.row_payload_bytes)
        for m, (keys, payload) in enumerate(inputs):
            w = texecs[m % 2].get_writer(port_handle, m)
            w.write_batch(keys, payload)
            w.close()
            for lo, hi in ((0, P), (2, 7), (P - 1, P), (5, 5), (9, 3)):
                assert texecs[m % 2].resolver.local_blocks(
                    handle.shuffle_id, m, lo, hi) == execs[
                        m % 2].resolver.local_blocks(handle.shuffle_id, m,
                                                     lo, hi)
        assert texecs[0].resolver.map_ids(handle.shuffle_id) == \
            execs[0].resolver.map_ids(handle.shuffle_id) == [0, 2]
        assert texecs[0].resolver.local_blocks(handle.shuffle_id, 1, 0,
                                               P) is None
        _assert_same(_run("port", "fused_rounds", texecs, port_handle,
                          vmesh, impl="ring", expect_maps=MAPS),
                     _run("port", "fused_rounds", execs, handle, vmesh,
                          impl="ring"), kind)


def test_empty_shuffle(cluster, mesh, vmesh):
    driver, execs = cluster
    handle = driver.register_shuffle(110, num_maps=1, num_partitions=4,
                                     partitioner=PartitionerSpec("modulo"))
    w = execs[0].get_writer(handle, 0)
    w.close()  # empty map output
    want = jms.run_mesh_reduce(execs, handle, mesh)
    for variant in VARIANTS:
        got = _run("port", variant, execs, handle, vmesh, impl="ring",
                   expect_maps=1)
        _assert_same(got, want, variant)
        assert all(len(k) == 0 for k, _, _ in got)


def test_overflow_raises_on_both(cluster, mesh, vmesh):
    """All keys hit one partition: skew beyond ``out_factor`` raises,
    never truncates."""
    driver, execs = cluster
    handle = driver.register_shuffle(111, num_maps=1, num_partitions=16,
                                     partitioner=PartitionerSpec("modulo"))
    w = execs[0].get_writer(handle, 0)
    w.write_batch(np.zeros(4096, dtype=np.uint64))  # all -> partition 0
    w.close()
    for variant in ("one_shot", "fused_one_shot"):
        with pytest.raises(OverflowError):
            _run("jax", variant, execs, handle, mesh, out_factor=1)
    for variant in ("one_shot", "fused_one_shot", "fused_rounds",
                    "streamed", "streamed_sequential"):
        for impl in ("ring", "gather"):
            with pytest.raises(OverflowError):
                _run("port", variant, execs, handle, vmesh, impl=impl,
                     out_factor=1)


def test_missing_map_raises_fetch_failed(cluster, shuffles, mesh, vmesh):
    """``expect_maps`` past what was committed: the first missing map
    raises the port's ``FetchFailedError`` with JAX's message."""
    _, execs = cluster
    handle, _ = shuffles["modulo"]
    with pytest.raises(jfetcher.FetchFailedError) as jerr:
        jms.run_mesh_reduce(execs, handle, mesh, expect_maps=MAPS + 2)
    for variant in VARIANTS:
        with pytest.raises(tfetcher.FetchFailedError) as terr:
            _run("port", variant, execs, handle, vmesh, impl="ring",
                 expect_maps=MAPS + 2)
        assert str(terr.value) == str(jerr.value)
        assert (terr.value.shuffle_id, terr.value.map_id,
                terr.value.exec_index, terr.value.verdict) == (
            handle.shuffle_id, MAPS, -1, "peer_lost")


def test_duplicate_map_is_staged_once(cluster, mesh, vmesh):
    """Map 0 committed on both executors (a retried or speculative task)
    is reduced once, from the first executor holding it."""
    driver, execs = cluster
    inputs = [_map_input("modulo", m, 8) for m in range(3)]
    handle = _write(driver, execs, 112, PartitionerSpec("modulo"), 8,
                    inputs, lambda m: [0, 1] if m == 0 else [m % 2])
    assert 0 in execs[0].resolver.map_ids(112)
    assert 0 in execs[1].resolver.map_ids(112)
    for variant in ("one_shot", "fused_rounds"):
        want = _run("jax", variant, execs, handle, mesh, expect_maps=3)
        got = _run("port", variant, execs, handle, vmesh, impl="ring",
                   expect_maps=3)
        _assert_same(got, want, variant)
        assert sum(len(k) for k, _, _ in got) == 3 * ROWS_PER_MAP


class _FlakyResolver:
    """A resolver whose ``local_blocks`` raises ``error`` for one map."""

    def __init__(self, inner, bad_map, error):
        self.inner, self.bad_map, self.error = inner, bad_map, error

    def map_ids(self, shuffle_id):
        return self.inner.map_ids(shuffle_id)

    def local_blocks(self, shuffle_id, map_id, start, end):
        if map_id == self.bad_map:
            raise self.error
        return self.inner.local_blocks(shuffle_id, map_id, start, end)


class _Manager:
    def __init__(self, resolver):
        self.resolver = resolver


@pytest.mark.parametrize("error", ["corrupt", "oserror"])
def test_corrupt_map_is_skipped(cluster, shuffles, mesh, vmesh, error):
    """A map whose read raises its package's ``CorruptOutputError`` (or an
    ``OSError``) is skipped on that executor and staged from the next one
    holding it; with no other holder it is missing."""
    _, execs = cluster
    handle, _ = shuffles["hash"]
    results = {}
    for pkg, integ, m in (("jax", jintegrity, mesh),
                          ("port", tintegrity, vmesh)):
        err = (integ.CorruptOutputError("shuffle_102_0.data", "crc")
               if error == "corrupt" else OSError(5, "EIO"))
        flaky = _Manager(_FlakyResolver(execs[0].resolver, 0, err))
        kw = {} if pkg == "jax" else {"impl": "ring"}
        managers = [_Manager(None), flaky, execs[0], execs[1]]
        results[pkg] = _run(pkg, "one_shot", managers, handle, m,
                            expect_maps=MAPS, **kw)
        fetch_failed = (jfetcher if pkg == "jax" else tfetcher
                        ).FetchFailedError
        with pytest.raises(fetch_failed, match="map 0 "):
            _run(pkg, "one_shot", [flaky, execs[1]], handle, m,
                 expect_maps=MAPS, **kw)
    _assert_same(results["port"], results["jax"])
    assert sum(len(k) for k, _, _ in results["port"]) == MAPS * ROWS_PER_MAP


def test_port_skips_only_its_own_corrupt_error(cluster, shuffles, vmesh):
    """The port catches the port's ``CorruptOutputError``, not JAX's:
    resolvers the port stages from raise the port's error."""
    _, execs = cluster
    handle, _ = shuffles["hash"]
    flaky = _Manager(_FlakyResolver(
        execs[0].resolver, 0, jintegrity.CorruptOutputError("p", "crc")))
    with pytest.raises(jintegrity.CorruptOutputError):
        tms.run_mesh_reduce(execs[1:] + [flaky], handle, vmesh, impl="ring")


def _canon(keys, payload):
    rows = np.concatenate([keys[:, None].view(np.uint8).reshape(
        len(keys), 8), payload], axis=1)
    return rows[np.lexsort(rows.T[::-1])]


def test_read_to_device_matches_jax(cluster, shuffles):
    """The on-ramp stages the same records as JAX's
    ``TpuShuffleReader.read_to_device`` over the same shuffle (as a
    multiset: JAX's order is its fetch order), and exactly the bytes of
    its chunks, decoded."""
    _, execs = cluster
    handle, _ = shuffles["range"]
    width = handle.row_payload_bytes
    jk, jp = execs[0].get_reader(handle, 0, P).read_to_device(execs[0].pool)
    jk = np.asarray(jk).copy().view(np.uint64).reshape(-1)
    chunks = [execs[m % 2].resolver.local_blocks(handle.shuffle_id, m, 0, P)
              for m in range(MAPS)]
    keys, payload = read_to_device(chunks, width, "cpu")
    assert keys.dtype == torch.int32 and keys.shape == (len(jk), 2)
    assert payload.dtype == torch.uint8 and payload.shape == (len(jk), width)
    tk = keys.numpy().view(np.uint32).copy().view(np.uint64).reshape(-1)
    np.testing.assert_array_equal(_canon(tk, payload.numpy()),
                                  _canon(jk, np.asarray(jp)))
    dk, dp = twriter.decode_rows(b"".join(chunks), width)
    np.testing.assert_array_equal(tk, dk)
    np.testing.assert_array_equal(payload.numpy(), dp)
    # the chunk kinds a fetch hands over
    again = read_to_device([bytearray(chunks[0]), memoryview(chunks[1]),
                            np.frombuffer(chunks[2], np.uint8)], width,
                           "cpu")
    n = sum(len(c) for c in chunks[:3]) // (8 + width)
    assert torch.equal(again[0], keys[:n]) and torch.equal(again[1],
                                                           payload[:n])


def test_read_to_device_empty_and_misaligned():
    keys, payload = read_to_device([], 12, "cpu")
    assert keys.shape == (0, 2) and keys.dtype == torch.int32
    assert payload.shape == (0, 12) and payload.dtype == torch.uint8
    keys, payload = read_to_device([b"", b""], 0, "cpu")
    assert keys.shape == (0, 2) and payload.shape == (0, 0)
    with pytest.raises(ValueError) as jerr:
        jwriter.decode_rows(b"\x01" * 41, 12)
    # one misaligned chunk among aligned ones: the whole read refuses
    with pytest.raises(ValueError) as terr:
        read_to_device([b"\x00" * 40, b"\x01" * 41], 12, "cpu")
    assert str(terr.value) == str(jerr.value)


def test_read_to_device_default_device_is_cuda(monkeypatch):
    """No device asked for and no card: the on-ramp raises, it never
    stages to the CPU silently."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        read_to_device([b"\x00" * 16], 8)


HISTS = [np.zeros((2, 16), np.int64),
         np.kron(np.eye(2, dtype=np.int64), np.full((1, 8), 100)),
         np.random.default_rng(0).integers(0, 1000, (2, 16)),
         np.random.default_rng(1).integers(0, 50, (2, 40)),
         np.random.default_rng(2).integers(0, 5, (3, 24))]


@pytest.mark.parametrize("sizes", [(4, 4), (2, 6), (8,), (3, 3, 2)])
@pytest.mark.parametrize("hist_id", range(len(HISTS)))
def test_slice_aligned_partition_map_matches_jax(sizes, hist_id):
    hist = HISTS[hist_id]
    if hist.shape[0] != len(sizes):
        hist = np.resize(hist, (len(sizes), hist.shape[1]))
    want = jplanner.slice_aligned_partition_map(
        hist, jtopo.Topology(sizes), D)
    got = tplanner.slice_aligned_partition_map(hist, ttopo.Topology(sizes),
                                               D)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_slice_aligned_partition_map_cases():
    """The JAX package's own cases (tests/test_topology.py), on the port."""
    assert (tplanner.ReducePlanner.BALANCE_FACTOR
            == jplanner.ReducePlanner.BALANCE_FACTOR)
    flat = tplanner.slice_aligned_partition_map(
        np.zeros((1, 6), np.int64), ttopo.Topology((4,)), 4)
    np.testing.assert_array_equal(flat, np.arange(6) % 4)
    np.testing.assert_array_equal(
        tplanner.slice_aligned_partition_map(
            np.ones((1, 11), np.int64), None, D), np.arange(11) % D)
    topo = ttopo.Topology((4, 4))
    hist = np.zeros((2, 16), np.int64)
    hist[0, :8] = 100
    hist[1, 8:] = 100
    pmap = tplanner.slice_aligned_partition_map(hist, topo, 8)
    assert (pmap[:8] < 4).all() and (pmap[8:] >= 4).all()
    assert np.bincount(pmap, minlength=8).max() == 2
    solo = np.zeros((2, 16), np.int64)
    solo[0] = 100
    smap = tplanner.slice_aligned_partition_map(solo, topo, 8)
    assert (smap < 4).any() and (smap >= 4).any()


@pytest.mark.parametrize("width", [0, 1, 5, 8, 92])
def test_row_packing_matches_jax(width):
    rng = np.random.default_rng(width)
    keys = rng.integers(0, 2**64, 300, dtype=np.uint64)
    payload = rng.integers(0, 256, (300, width), dtype=np.uint8)
    assert tms.device_row_words(width) == jms.device_row_words(width)
    rows = tms._rows_to_u32(keys, payload)
    np.testing.assert_array_equal(rows, jms._rows_to_u32(keys, payload))
    for got, want in zip(tms._u32_to_rows(rows, width),
                         jms._u32_to_rows(rows, width)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    for got, want in zip(tms._u32_to_rows(rows[:0], width),
                         jms._u32_to_rows(rows[:0], width)):
        assert got.dtype == want.dtype and got.shape == want.shape
    data = rng.integers(0, 256, 300 * (8 + width), dtype=np.uint8).tobytes()
    for copy in (True, False):
        for got, want in zip(twriter.decode_rows(data, width, copy=copy),
                             jwriter.decode_rows(data, width, copy=copy)):
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("spec", [("hash", None), ("modulo", None),
                                  ("range", (5, 2**40, 2**63))])
def test_partitioner_spec_matches_jax(spec):
    keys = np.random.default_rng(3).integers(0, 2**64, 2000,
                                             dtype=np.uint64)
    for n in (1, 7, 200):
        want = PartitionerSpec(*spec).build(n)(keys)
        got = tmanager.PartitionerSpec(*spec).build(n)(keys)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="unknown partitioner kind"):
        tmanager.PartitionerSpec("zipf").build(4)


def test_error_classes_match_jax():
    assert str(tfetcher.FetchFailedError(3, 4, 5, "gone", "corrupt_output")
               ) == str(jfetcher.FetchFailedError(3, 4, 5, "gone",
                                                  "corrupt_output"))
    t = tintegrity.CorruptOutputError("/x.data", "crc mismatch")
    j = jintegrity.CorruptOutputError("/x.data", "crc mismatch")
    assert str(t) == str(j) and t.path == j.path
    m = tfetcher.ReadMetrics()
    m.record_local(100)
    m.record_local(20)
    assert (m.local_bytes, m.local_fetches, m.remote_fetches) == (120, 2, 0)
