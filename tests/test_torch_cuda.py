"""Card-only tests of the port: the CUDA ring all-to-all kernel against its
plain version (at the TeraSort, chunked and workload block widths; both
bodies, at the TMA body's tile edges and pipeline depths, at the shard
limit, on a side stream and replayed in a CUDA graph), its argument
checks, the TeraSort step and the chunked exchange on the card against
the same calls on the CPU, q95 and q64 on the ring against ``dense``,
pinned staging, the round and hierarchical drivers, and a mesh-mode
engine job. Marked ``cuda``; each skips with a reason where there is no
card. This file imports no JAX, so it runs on a
machine without it:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from sparkrdma_tpu_torch.ops import ring_exchange as tre

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _blocks(shape, seed, device):
    rng = np.random.default_rng(seed)
    host = rng.integers(-2**31, 2**31, size=shape, dtype=np.int64)
    return torch.from_numpy(host.astype(np.int32)).to(device)


@pytest.mark.parametrize("shape", [(1, 1, 4, 4), (2, 2, 1, 1), (3, 3, 5, 7),
                                   (8, 8, 3, 3), (8, 8, 4, 4),
                                   (8, 8, 1000, 25), (5, 5, 4099, 1),
                                   (8, 8, 513, 3), (8, 8, 1024, 2)])
def test_kernel_matches_plain(cuda, shape):
    x = _blocks(shape, sum(shape), cuda)
    before = tre.LAUNCHES
    at_shape = tre.SHAPES.get(shape, 0)
    got = tre.ring_all_to_all(x)
    torch.cuda.synchronize()
    assert tre.LAUNCHES == before + 1
    assert tre.SHAPES[shape] == at_shape + 1
    assert torch.equal(got, tre.ring_all_to_all_plain(x))
    assert torch.equal(got, x.transpose(0, 1).contiguous())


def test_kernel_unaligned_base_pointer(cuda):
    """A contiguous view that starts 4 bytes into its storage: no block is
    16-byte aligned, so every word takes the scalar path."""
    shape = (4, 4, 6, 8)
    flat = _blocks((1 + int(np.prod(shape)),), 3, cuda)
    x = flat[1:].view(shape)
    assert x.is_contiguous() and x.data_ptr() % 16
    got = tre.ring_all_to_all(x)
    torch.cuda.synchronize()
    assert torch.equal(got, tre.ring_all_to_all_plain(x))


def test_kernel_refuses_bad_arguments(cuda):
    with pytest.raises(TypeError, match="int32"):
        tre.ring_all_to_all(torch.zeros((2, 2, 3, 3), device=cuda))
    with pytest.raises(ValueError, match=r"\[D, D, C, W\]"):
        tre.ring_all_to_all(torch.zeros((2, 3, 3, 3), dtype=torch.int32,
                                        device=cuda))
    with pytest.raises(ValueError, match="contiguous"):
        tre.ring_all_to_all(torch.zeros((2, 2, 3, 3), dtype=torch.int32,
                                        device=cuda).transpose(0, 1))


@pytest.mark.parametrize("impl", ["ring", "dense", "gather"])
def test_terasort_step_on_card_matches_cpu(cuda, impl):
    from sparkrdma_tpu_torch.models.terasort import (
        TeraSortConfig, generate_rows, make_terasort_step)
    from sparkrdma_tpu_torch.parallel.mesh import VirtualMesh
    from sparkrdma_tpu_torch.utils.u32 import rows_from_numpy

    cfg = TeraSortConfig(rows_per_device=4096, payload_words=24)
    rows = generate_rows(cfg, 8, seed=9)
    rows[::17, 0] = 2**32 - 1
    outs = []
    for mesh in (VirtualMesh(8, cuda), VirtualMesh(8, "cpu")):
        step = make_terasort_step(mesh, cfg, impl=impl)
        outs.append([t.cpu() for t in step(rows_from_numpy(rows, mesh))])
    for got, want in zip(*outs):
        assert torch.equal(got, want)


@pytest.mark.parametrize("impl", ["ring", "dense", "gather"])
def test_chunked_exchange_on_card_matches_cpu(cuda, impl):
    """A skewed multi-round chunked exchange (3-word rows, non-pow2
    quota): the card's rows and round count equal the CPU's, and the ring
    rounds launch the kernel once each."""
    from sparkrdma_tpu_torch.parallel.exchange import chunked_exchange
    from sparkrdma_tpu_torch.parallel.mesh import VirtualMesh

    rng = np.random.default_rng(11)
    counts = rng.integers(0, 300, (8, 8))
    counts[:, 0] = 1500                        # everyone floods shard 0
    cap = int(counts.sum(axis=1).max())
    rows = rng.integers(0, 2**32, (8 * cap, 3), dtype=np.uint32)
    before = tre.LAUNCHES
    got, rounds = chunked_exchange(VirtualMesh(8, cuda), rows, counts,
                                   quota=300, impl=impl)
    launched = tre.LAUNCHES - before
    want, want_rounds = chunked_exchange(VirtualMesh(8, "cpu"), rows, counts,
                                         quota=300, impl=impl)
    assert rounds == want_rounds == 3          # 1500 rows in rounds of 512
    assert launched == (rounds if impl == "ring" else 0)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


TILE_WORDS = tre.TMA_TILE_BYTES // 4


def _bodies_launched(fn):
    """``fn()`` and the kernel launches it made, per body."""
    before = dict(tre.BODIES)
    out = fn()
    torch.cuda.synchronize()
    return out, {k: v - before.get(k, 0) for k, v in tre.BODIES.items()
                 if v != before.get(k, 0)}


@pytest.mark.parametrize("d", [1, 2, 3, 8])
@pytest.mark.parametrize("c,w", [
    (100, 4),                      # a block smaller than one tile
    (TILE_WORDS // 2, 2),          # exactly one tile
    (TILE_WORDS // 4 + 1, 4),      # one tile + 16 bytes
    (3 * TILE_WORDS // 4 + 7, 4),  # three tiles + a 112-byte tail
])
def test_tma_body_at_tile_edges(cuda, d, c, w):
    x = _blocks((d, d, c, w), d * 1000 + c + w, cuda)
    got, bodies = _bodies_launched(lambda: tre.ring_all_to_all(x))
    assert bodies == {"tma": 1}
    assert torch.equal(got, tre.ring_all_to_all_plain(x))


@pytest.mark.parametrize("stages,ctas_per_sm", [(2, 1), (3, 2), (8, 1)])
def test_tma_body_pipeline_depths(cuda, stages, ctas_per_sm):
    """Other stage counts and grids than the default, with more tiles
    per CTA than stages: the stage parities wrap several times."""
    x = _blocks((8, 8, 5 * TILE_WORDS // 4 + 3, 4), stages, cuda)
    out = torch.empty_like(x)
    src, dst = tre._pointer_table(x, out)
    tre._launch(x, out, "tma", src, dst, tile_bytes=4096, stages=stages,
                ctas_per_sm=ctas_per_sm)
    torch.cuda.synchronize()
    assert torch.equal(out, tre.ring_all_to_all_plain(x))


@pytest.mark.parametrize("offset,c,w", [(1, 6, 8), (0, 3, 3), (0, 5, 7)])
def test_unaligned_views_take_the_load_store_body(cuda, offset, c, w):
    """A base 4 bytes off 16, or a block size that is no multiple of 16:
    the load/store body, bit-equal all the same."""
    d = 4
    flat = _blocks((offset + d * d * c * w,), 7 + c, cuda)
    x = flat[offset:].view(d, d, c, w)
    got, bodies = _bodies_launched(lambda: tre.ring_all_to_all(x))
    assert bodies == {"ldst": 1}
    assert torch.equal(got, tre.ring_all_to_all_plain(x))


def test_tma_body_refuses_a_misaligned_base(cuda):
    """Asked for the TMA body on a misaligned base, the launcher refuses
    and the wrapper raises; nothing is copied."""
    flat = _blocks((1 + 2 * 2 * 4 * 4,), 5, cuda)
    x = flat[1:].view(2, 2, 4, 4)
    out = torch.zeros_like(x)
    src, dst = tre._pointer_table(x, out)
    with pytest.raises(RuntimeError, match="tma body"):
        tre._launch(x, out, "tma", src, dst)
    torch.cuda.synchronize()
    assert not out.any()


@pytest.mark.parametrize("shape", [(8, 8, 1000, 4), (8, 8, 3, 3)])
def test_launch_replays_in_a_cuda_graph(cuda, shape):
    """A launch captured in a CUDA graph and replayed on new input
    equals the plain version on that input (both bodies)."""
    static_in = _blocks(shape, 1, cuda)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):            # warm-up outside the capture
        tre.ring_all_to_all(static_in)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        static_out = tre.ring_all_to_all(static_in)
    for seed in (2, 3):
        fresh = _blocks(shape, seed, cuda)
        static_in.copy_(fresh)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(static_out, tre.ring_all_to_all_plain(fresh))


def test_launches_on_a_side_stream(cuda):
    """The kernel runs on the caller's current stream: launched on a side
    stream behind the producer of its input, it sees that input."""
    main = torch.cuda.current_stream()
    x = _blocks((8, 8, 4096, 2), 4, cuda)
    y = x + 1                                   # produced on the main stream
    side = torch.cuda.Stream()
    side.wait_stream(main)
    with torch.cuda.stream(side):
        outs = [tre.ring_all_to_all(y) for _ in range(3)]
    main.wait_stream(side)
    for out in outs:
        out.record_stream(main)
    torch.cuda.synchronize()
    want = tre.ring_all_to_all_plain(y)
    for out in outs:
        assert torch.equal(out, want)


@pytest.mark.parametrize("c,w,body", [(4, 1, "tma"), (3, 1, "ldst")])
def test_most_shards(cuda, c, w, body):
    """``MAX_SHARDS`` shards: the whole pointer table in use."""
    d = tre.MAX_SHARDS
    x = _blocks((d, d, c, w), c, cuda)
    got, bodies = _bodies_launched(lambda: tre.ring_all_to_all(x))
    assert bodies == {body: 1}
    assert torch.equal(got, x.transpose(0, 1).contiguous())


def test_tpcds_queries_ring_equals_dense_on_card(cuda):
    """q95 and q64 at small size: the per-shard partials on the ring (the
    kernel) equal those on ``dense`` bit for bit, and their sums the
    numpy oracles; the ring path launches the kernel 8 times per query."""
    from sparkrdma_tpu_torch.models import tpcds_queries as tq
    from sparkrdma_tpu_torch.parallel.device_plane import stage_to_device
    from sparkrdma_tpu_torch.parallel.mesh import VirtualMesh

    mesh = VirtualMesh(8, cuda)
    for cfg, gen, make, by_shard in (
            (tq.Q95Config(ws_rows_per_device=768, num_orders=600),
             tq.generate_q95, tq.make_q95_step, tq.numpy_q95_by_shard),
            (tq.Q64Config(ss_rows_per_device=640, cs_rows_per_device=512,
                          num_items=300), tq.generate_q64, tq.make_q64_step,
             tq.numpy_q64_by_shard)):
        tables = gen(cfg, 8, 9)
        args = [stage_to_device(tq.pad_rows_to_devices(t, 8), mesh)
                for t in tables]
        outs = {}
        for impl in ("ring", "dense"):
            before = tre.LAUNCHES
            outs[impl] = [t.cpu() for t in make(mesh, cfg, impl)(*args)]
            torch.cuda.synchronize()
            assert tre.LAUNCHES - before == (8 if impl == "ring" else 0)
        for got, want in zip(outs["ring"], outs["dense"]):
            assert torch.equal(got, want)
        assert not outs["ring"][1].any()
        np.testing.assert_array_equal(outs["ring"][0].numpy(),
                                      by_shard(*tables, cfg, 8))


def test_stage_to_device_goes_through_pinned_memory(cuda):
    from sparkrdma_tpu_torch.parallel import device_plane as tdp
    from sparkrdma_tpu_torch.parallel.mesh import VirtualMesh

    arr = np.arange(64 * 3, dtype=np.uint32).reshape(64, 3)
    arr[5, 1] = 2**32 - 1
    staged = tdp.stage_to_device(arr, VirtualMesh(8, cuda))
    assert staged.is_cuda and staged.shape == (8, 8, 3)
    np.testing.assert_array_equal(
        staged.cpu().numpy().reshape(64, 3).view(np.uint32), arr)
    # the round driver's staging slots are pinned, and a slot is refilled
    # only after its last upload has landed
    io = tdp._RoundIO(cuda, 2)
    chunk = arr[:40]
    rows_d, dest_d = io.upload(0, chunk, np.arange(40, dtype=np.int32) % 8,
                               8, 64)
    assert io._up[0][0].is_pinned() and io._up[0][1].is_pinned()
    rows_d2, _ = io.upload(0, arr[40:], np.zeros(24, np.int32), 8, 64)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(
        rows_d.cpu().numpy().reshape(64, 3)[:40].view(np.uint32), chunk)
    assert (rows_d.cpu().numpy().reshape(64, 3)[40:] == 0).all()
    assert (dest_d.cpu().numpy().reshape(-1)[40:] == -1).all()
    np.testing.assert_array_equal(
        rows_d2.cpu().numpy().reshape(64, 3)[:24].view(np.uint32), arr[40:])


def test_round_drivers_on_card(cuda):
    """The double-buffered driver on the card: pipelined and sequential
    runs are byte-equal and equal the CPU's; the hierarchical driver on
    two slices equals the flat one; the ring launches once per round."""
    from sparkrdma_tpu_torch.parallel import device_plane as tdp
    from sparkrdma_tpu_torch.parallel.mesh import VirtualMesh
    from sparkrdma_tpu_torch.parallel.topology import Topology

    rng = np.random.default_rng(12)
    n_rows = 20000
    rows = rng.integers(0, 2**32, (n_rows, 25), dtype=np.uint32)
    dest = (rows[:, :2].copy().view(np.uint64).reshape(-1) % 8).astype(
        np.int32)
    home = (np.arange(n_rows) * 8 // n_rows // 4).astype(np.int32)
    kw = dict(key_words=2, rows_per_round=1000, out_factor=2)
    mesh = VirtualMesh(8, cuda)
    before = tre.LAUNCHES
    piped, rounds = tdp.run_fused_exchange(mesh, rows, dest, **kw)
    assert rounds == 3 and tre.LAUNCHES - before == rounds
    seq, _ = tdp.run_fused_exchange(mesh, rows, dest, pipeline_rounds=False,
                                    **kw)
    cpu, _ = tdp.run_fused_exchange(VirtualMesh(8, "cpu"), rows, dest,
                                    impl="ring", **kw)
    hier, _ = tdp.run_hierarchical_exchange(mesh, Topology((4, 4)), rows,
                                            dest, home, **kw)
    for d in range(8):
        for other in (seq, cpu, hier):
            np.testing.assert_array_equal(piped[d], other[d])
        keys = piped[d][:, :2].copy().view(np.uint64).reshape(-1)
        assert (keys % 8 == d).all() and (keys[:-1] <= keys[1:]).all()


@pytest.fixture(scope="module")
def committed_stage(tmp_path_factory):
    """A driver and two executors of the port on localhost holding 3 map
    outputs of random records, hash-partitioned into 200 partitions and
    written through the executors' writers; yields (the executors'
    managers, the handle) and stops every manager."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the CUDA kernel has no CPU mode")
    from sparkrdma_tpu_torch.config import TpuShuffleConf
    from sparkrdma_tpu_torch.shuffle.manager import (
        PartitionerSpec,
        TpuShuffleManager,
    )

    maps, rows, width, partitions = 3, 4000, 92, 200
    tmp = tmp_path_factory.mktemp("committed_stage")
    conf = TpuShuffleConf(connect_timeout_ms=5000)
    driver = TpuShuffleManager(conf, is_driver=True)
    executors = []
    try:
        executors = [TpuShuffleManager(conf, driver_addr=driver.driver_addr,
                                       executor_id=str(i),
                                       spill_dir=str(tmp / f"e{i}"))
                     for i in range(2)]
        for ex in executors:
            ex.executor.wait_for_members(2)
        handle = driver.register_shuffle(1, num_maps=maps,
                                         num_partitions=partitions,
                                         partitioner=PartitionerSpec("hash"),
                                         row_payload_bytes=width)
        rng = np.random.default_rng(21)
        for m in range(maps):
            writer = executors[m % 2].get_writer(handle, m)
            writer.write_batch(
                rng.integers(0, 2**64, rows, dtype=np.uint64),
                rng.integers(0, 256, (rows, width), dtype=np.uint8))
            writer.close()
        yield executors, handle
    finally:
        for ex in executors:
            ex.stop()
        driver.stop()


def test_read_to_device_on_card(cuda, committed_stage):
    """The on-ramp stages through a pinned buffer onto the card, byte-equal
    after download, and its result stands when the caller reuses or frees
    the chunks right after return."""
    from sparkrdma_tpu_torch.shuffle import reader as treader
    from sparkrdma_tpu_torch.shuffle.writer import decode_rows

    executors, handle = committed_stage
    width = handle.row_payload_bytes
    chunks = [bytearray(executors[m % 2].resolver.local_blocks(
        1, m, 0, handle.num_partitions)) for m in range(handle.num_maps)]
    want_keys, want_payload = decode_rows(b"".join(chunks), width)
    assert treader._gather(chunks, 8 + width, pin=True).is_pinned()
    keys, payload = treader.read_to_device(chunks, width)
    for chunk in chunks:          # the caller reuses its buffers at once
        chunk[:] = bytes(len(chunk))
    del chunks
    assert keys.is_cuda and payload.is_cuda
    assert keys.dtype == torch.int32 and keys.shape == (len(want_keys), 2)
    np.testing.assert_array_equal(
        keys.cpu().numpy().view(np.uint32).copy().view(np.uint64)
        .reshape(-1), want_keys)
    np.testing.assert_array_equal(payload.cpu().numpy(), want_payload)
    empty_keys, empty_payload = treader.read_to_device([], width)
    assert empty_keys.is_cuda and empty_keys.shape == (0, 2)
    assert empty_payload.shape == (0, width)


@pytest.mark.parametrize("rows_per_round", [0, 1000])
def test_mesh_reduce_fused_on_card_matches_cpu(cuda, committed_stage,
                                               rows_per_round):
    """The fused mesh reduce on the card (the ring kernel once per round)
    equals the same call on the CPU, byte for byte."""
    from sparkrdma_tpu_torch.parallel.mesh import VirtualMesh
    from sparkrdma_tpu_torch.shuffle import mesh_service as tms

    executors, handle = committed_stage
    before = tre.LAUNCHES
    got = tms.run_mesh_reduce_fused(executors, handle, VirtualMesh(8, cuda),
                                    rows_per_round=rows_per_round,
                                    expect_maps=handle.num_maps)
    assert tre.LAUNCHES - before == (2 if rows_per_round else 1)
    want = tms.run_mesh_reduce_fused(executors, handle,
                                     VirtualMesh(8, "cpu"), impl="ring",
                                     rows_per_round=rows_per_round)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)
    assert sum(len(k) for k, _, _ in got) == 3 * 4000


@pytest.mark.parametrize("P", [16, 4])
def test_engine_job_on_card_rides_the_device_plane(cuda, tmp_path,
                                                   monkeypatch, P):
    """A small mesh-mode ``DAGEngine`` job on the card: the cost model
    picks the device plane, the ring kernel runs, no stage degrades, no
    TCP fetcher is built, and every partition equals the host truth. With
    4 partitions a round's source shard sends to one or two destinations
    (committed outputs are partition-contiguous): the ring's slots must
    grow to the largest pair."""
    from sparkrdma_tpu_torch.config import TpuShuffleConf
    from sparkrdma_tpu_torch.engine import DAGEngine, MapStage, ResultStage
    from sparkrdma_tpu_torch.parallel.mesh import VirtualMesh
    from sparkrdma_tpu_torch.shuffle import fetcher as tfetcher
    from sparkrdma_tpu_torch.shuffle.manager import PartitionerSpec
    from sparkrdma_tpu_torch.shuffle.spark_compat import (
        ShuffleDependency,
        SparkCompatShuffleManager,
    )
    from sparkrdma_tpu_torch.utils.trace import Tracer

    built = {"n": 0}
    orig = tfetcher.ShuffleFetcher.__init__

    def spy(self, *a, **kw):
        built["n"] += 1
        return orig(self, *a, **kw)

    monkeypatch.setattr(tfetcher.ShuffleFetcher, "__init__", spy)
    maps, rows, width = 6, 3000, 12

    def table(m):
        rng = np.random.default_rng(500 + m)
        return (rng.integers(0, 2**64, rows, dtype=np.uint64),
                rng.integers(0, 256, (rows, width), dtype=np.uint8))

    def map_fn(ctx, writer, task_id):
        writer.write(table(task_id))

    def reduce_fn(ctx, task_id):
        reader = ctx.read(0)
        keys, payload = reader._r.read_all()
        return keys, payload, reader.metrics.remote_bytes

    conf = TpuShuffleConf(connect_timeout_ms=5000)
    driver = SparkCompatShuffleManager(conf, isDriver=True)
    execs = [SparkCompatShuffleManager(
        conf, driverAddr=driver.driverAddr, executorId=str(i),
        spill_dir=str(tmp_path / f"e{i}")) for i in range(2)]
    try:
        for ex in execs:
            ex.native.executor.wait_for_members(2)
        # a budget that bounds the stage to a few rounds
        engine = DAGEngine(driver, execs, mesh=VirtualMesh(8, cuda),
                           device_hbm_budget=200_000)
        engine.tracer = Tracer()
        stage = MapStage(maps, ShuffleDependency(
            P, PartitionerSpec("hash"), row_payload_bytes=width), map_fn)
        before = tre.LAUNCHES
        out = engine.run(ResultStage(P, reduce_fn, parents=[stage]))
        assert tre.LAUNCHES > before
    finally:
        for ex in execs:
            ex.stop()
        driver.stop()
    planes = [e["args"]["plane"]
              for e in engine.tracer.events("exchange.select")]
    assert planes == ["device"]
    assert engine.tracer.events("exchange.degrade") == []
    assert len(engine.tracer.events("exchange.round")) > 1
    assert built["n"] == 0
    keys, payload = (np.concatenate(c) for c in zip(
        *(table(m) for m in range(maps))))
    parts = PartitionerSpec("hash").build(P)(keys)
    for p, (got_k, got_p, remote) in enumerate(out):
        mine = np.flatnonzero(parts == p)
        order = mine[np.argsort(keys[mine], kind="stable")]
        np.testing.assert_array_equal(got_k, keys[order])
        np.testing.assert_array_equal(got_p, payload[order])
        assert remote == 0


@pytest.mark.parametrize("shape,offset", [((8, 8, 1000, 25), 0),
                                          ((4, 4, 7, 3), 1)])
def test_range_launches_make_the_full_launch(cuda, shape, offset):
    """Two launches over half the sources each, into one output, equal the
    full launch and the plain version: aligned (the TMA body) and at a
    view 4 bytes into its storage with odd blocks (load/store)."""
    d = shape[0]
    flat = _blocks((offset + int(np.prod(shape)),), d, cuda)
    x = flat[offset:].view(shape)
    out = torch.full_like(x, -1)
    src, dst = tre._pointer_table(x, out)
    body = tre.body_for(src, dst, shape[2] * shape[3] * 4)
    assert body == ("tma" if offset == 0 else "ldst")
    half = d // 2
    tre._launch(x, out, body, src[:half], dst, src_begin=0)
    tre._launch(x, out, body, src[half:], dst, src_begin=half)
    torch.cuda.synchronize()
    assert torch.equal(out, tre.ring_all_to_all(x))
    assert torch.equal(out, tre.ring_all_to_all_plain(x))


_IPC_WORKER = r'''
import sys
import numpy as np
import torch
from sparkrdma_tpu_torch.ops import ring_exchange as tre
from sparkrdma_tpu_torch.parallel import multihost
pid, port = int(sys.argv[1]), sys.argv[2]
multihost.init_multihost(f"127.0.0.1:{port}", 2, pid, local_device_count=4,
                         platform="cuda")
mesh = multihost.global_mesh()
for shape in ((8, 8, 1000, 25), (8, 8, 7, 3)):
    rng = np.random.default_rng(sum(shape))
    glob = torch.from_numpy(rng.integers(-2**31, 2**31, shape).astype(
        np.int32)).to(mesh.device)
    mine = glob[pid * 4:(pid + 1) * 4].contiguous()
    got = tre.ring_all_to_all_peers(mine, mesh).clone()
    want = tre.ring_all_to_all_plain(glob)[pid * 4:(pid + 1) * 4]
    assert torch.equal(got, want), shape
assert tre.LAUNCHES == 2 and set(tre.BODIES) == {"tma", "ldst"}, tre.BODIES
multihost.shutdown_multihost()
print("IPC_OK", pid, flush=True)
'''


def test_two_process_ipc_exchange_on_card(cuda):
    """Two processes share the card, 4 shards each: each launches the
    kernel over its own sources, writing through CUDA IPC peer pointers
    into both receive arenas, and each arena equals the plain move."""
    import os
    import socket
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = str(s.getsockname()[1])
    env = dict(os.environ)
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    procs = [subprocess.Popen([sys.executable, "-c", _IPC_WORKER, str(i),
                               port], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, env=env, cwd=root)
             for i in range(2)]
    try:
        outs = [p.communicate(timeout=180)[0].decode() for p in procs]
    finally:
        for p in procs:
            p.kill()
    for i, out in enumerate(outs):
        assert f"IPC_OK {i}" in out, out[-3000:]
