"""Card-only tests of the port: the CUDA ring all-to-all kernel against its
plain version (at the TeraSort, chunked and workload block widths; at
its tile edges, every alignment and the tiny aligned blocks the paths
launch, inside guard words; at the shard limit, on a side stream and
replayed in a CUDA graph), its argument
checks, the TeraSort step and the chunked exchange on the card against
the same calls on the CPU, q95 and q64 on the ring against ``dense``,
pinned staging, the round and hierarchical drivers, and a mesh-mode
engine job; the ragged all-to-all kernel (the ``native`` transport)
against its plain version and the ``gather`` transport, inside guard
words, at every alignment, at the shard limit and replayed in a CUDA
graph, its range launches from a later source into one local tensor,
and its cross-process exchange in two processes sharing the card; the
receive merge kernel (``ops/run_merge.py``) against ``sort_received``,
at the count edges, an unaligned view and TeraSort's receive of HiBench
large from a range exchange, in bounds on runs that are not sorted, and
a ring or dense range step with a slot pair past its slot refused.
Marked ``cuda``; each skips with a reason where there is no
card. This file imports no JAX, so it runs on a
machine without it:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from sparkrdma_tpu_torch.ops import ragged_exchange as rex
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
    16-byte aligned, so the load/store body moves every word."""
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


@pytest.mark.parametrize("impl", ["ring", "dense", "gather", "native"])
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


@pytest.mark.parametrize("impl", ["ring", "dense", "gather", "native"])
def test_chunked_exchange_on_card_matches_cpu(cuda, impl):
    """A skewed multi-round chunked exchange (3-word rows, non-pow2
    quota): the card's rows and round count equal the CPU's, and the ring
    and native rounds launch their kernel once each."""
    from sparkrdma_tpu_torch.parallel.exchange import chunked_exchange
    from sparkrdma_tpu_torch.parallel.mesh import VirtualMesh

    rng = np.random.default_rng(11)
    counts = rng.integers(0, 300, (8, 8))
    counts[:, 0] = 1500                        # everyone floods shard 0
    cap = int(counts.sum(axis=1).max())
    rows = rng.integers(0, 2**32, (8 * cap, 3), dtype=np.uint32)
    before = tre.LAUNCHES, rex.LAUNCHES
    got, rounds = chunked_exchange(VirtualMesh(8, cuda), rows, counts,
                                   quota=300, impl=impl)
    launched = tre.LAUNCHES - before[0], rex.LAUNCHES - before[1]
    want, want_rounds = chunked_exchange(VirtualMesh(8, "cpu"), rows, counts,
                                         quota=300, impl=impl)
    assert rounds == want_rounds == 3          # 1500 rows in rounds of 512
    assert launched == (rounds if impl == "ring" else 0,
                        rounds if impl == "native" else 0)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


# the kernel's warp tile: kTileVecs = 128 vectors of 4 words; a CTA of
# four warps takes four tiles
TILE_WORDS = 512


@pytest.mark.parametrize("d", [1, 2, 3, 8])
@pytest.mark.parametrize("c,w", [
    (3, 5),                        # shorter than a head plus a tail
    (TILE_WORDS // 4, 4),          # exactly one tile
    (TILE_WORDS + 1, 1),           # one tile + 1 word
    (3 * TILE_WORDS + 7, 4),       # three tile groups and a 28-word tail
])
def test_load_store_body_at_tile_edges(cuda, d, c, w):
    x = _blocks((d, d, c, w), d * 1000 + c + w, cuda)
    before = tre.LAUNCHES
    got = tre.ring_all_to_all(x)
    torch.cuda.synchronize()
    assert tre.LAUNCHES == before + 1
    assert torch.equal(got, tre.ring_all_to_all_plain(x))
    assert torch.equal(got, x.transpose(0, 1).contiguous())


@pytest.mark.parametrize("offset,c,w", [(1, 6, 8), (0, 3, 3), (0, 5, 7)])
def test_unaligned_views_take_the_load_store_body(cuda, offset, c, w):
    """A base 4 bytes off 16, or a block size that is no multiple of 16:
    the load/store body, bit-equal all the same."""
    d = 4
    flat = _blocks((offset + d * d * c * w,), 7 + c, cuda)
    x = flat[offset:].view(d, d, c, w)
    got = tre.ring_all_to_all(x)
    torch.cuda.synchronize()
    assert torch.equal(got, tre.ring_all_to_all_plain(x))


GUARD = 64              # guard words on each side of a guarded output
SENTINEL = 0x5A5A5A5A


@pytest.mark.parametrize("d", [1, 2, 3, 8])
@pytest.mark.parametrize("block_mod", [0, 4, 8, 12])
@pytest.mark.parametrize("offset", [0, 1, 2, 3])
def test_load_store_body_alignment_sweep(cuda, offset, block_mod, d):
    """The load/store body at every alignment: a source view ``offset``
    words into an aligned buffer, the output at another offset, blocks of
    ``C*W*4`` bytes with ``C*W*4 mod 16 = block_mod``: a few words, below
    one CTA's share, across several CTAs and 2 MB; the full launch and
    two range launches. Each equals the plain version, and the guard
    words around the output are untouched."""
    dst_offset = (offset + 1 + block_mod // 4) % 4
    for i, base in enumerate((4, 100, 10240, 1 << 19)):
        n = base + block_mod // 4
        gen = torch.Generator(device=cuda).manual_seed(offset * 97 + d + i)
        flat = torch.randint(-2**31, 2**31 - 1, (8 + d * d * n,),
                             dtype=torch.int32, device=cuda, generator=gen)
        pad = (-flat.data_ptr() // 4) % 4        # align the buffer's start
        x = flat[pad + offset:pad + offset + d * d * n].view(d, d, n, 1)
        assert x.data_ptr() % 16 == 4 * offset
        want = tre.ring_all_to_all_plain(x)
        for ranged in (False, True):
            buf = torch.full((2 * GUARD + 4 + d * d * n,), SENTINEL,
                             dtype=torch.int32, device=cuda)
            lo = GUARD + (-(buf.data_ptr() // 4 + GUARD)) % 4 + dst_offset
            out = buf[lo:lo + d * d * n].view(d, d, n, 1)
            assert out.data_ptr() % 16 == 4 * dst_offset
            src, dst = tre._pointer_table(x, out)
            if ranged:      # sources [0, d // 2), then [d // 2, d)
                for s0, s1 in ((0, d // 2), (d // 2, d)):
                    if s1 > s0:
                        tre._launch(x, src[s0:s1], dst, src_begin=s0)
            else:
                tre._launch(x, src, dst)
            torch.cuda.synchronize()
            case = (n, ranged)
            assert torch.equal(out, want), case
            assert (buf[:lo] == SENTINEL).all(), case
            assert (buf[lo + d * d * n:] == SENTINEL).all(), case


# the 16-byte-aligned blocks of 64 KB and less that the paths launch the
# kernel at (q95, q64, the engine's q95, the CLI's engine-mesh demo,
# device_bench's defaults)
TINY_ALIGNED_SHAPES = ((8, 8, 2, 2), (8, 8, 46, 2), (8, 8, 100, 2),
                       (8, 8, 2, 4), (8, 8, 46, 4), (8, 8, 100, 4),
                       (8, 8, 256, 4), (8, 8, 388, 4), (8, 8, 512, 4),
                       (8, 8, 256, 3), (8, 8, 4095, 4))


@pytest.mark.parametrize("shape", TINY_ALIGNED_SHAPES)
def test_tiny_aligned_blocks_inside_guard_words(cuda, shape):
    """A launch at a tiny aligned block shape, into an output with guard
    words on both sides: bit for bit the plain version and
    ``transpose(0, 1).contiguous()``, and the guard words untouched."""
    x = _blocks(shape, sum(shape), cuda)
    n = x.numel()
    buf = torch.full((2 * GUARD + 4 + n,), SENTINEL, dtype=torch.int32,
                     device=cuda)
    lo = GUARD + (-(buf.data_ptr() // 4 + GUARD)) % 4
    out = buf[lo:lo + n].view(shape)
    assert out.data_ptr() % 16 == 0
    before = tre.LAUNCHES
    tre._launch(x, *tre._pointer_table(x, out))
    torch.cuda.synchronize()
    assert torch.equal(out, tre.ring_all_to_all_plain(x))
    assert torch.equal(out, x.transpose(0, 1).contiguous())
    assert (buf[:lo] == SENTINEL).all() and (buf[lo + n:] == SENTINEL).all()
    assert torch.equal(tre.ring_all_to_all(x), out)
    assert tre.LAUNCHES == before + 1


@pytest.mark.parametrize("shape", [(8, 8, 1000, 4), (8, 8, 3, 3)])
def test_launch_replays_in_a_cuda_graph(cuda, shape):
    """A launch captured in a CUDA graph and replayed on new input
    equals the plain version on that input (aligned and odd blocks)."""
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


@pytest.mark.parametrize("c,w", [(4, 1), (3, 1)])
def test_most_shards(cuda, c, w):
    """``MAX_SHARDS`` shards: the whole pointer table in use."""
    d = tre.MAX_SHARDS
    x = _blocks((d, d, c, w), c, cuda)
    before = tre.LAUNCHES
    got = tre.ring_all_to_all(x)
    torch.cuda.synchronize()
    assert tre.LAUNCHES == before + 1
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
    two slices equals the flat one; ``auto`` is ``native``, whose kernel
    launches once per round, and the ring's run equals it."""
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
    before = rex.LAUNCHES
    piped, rounds = tdp.run_fused_exchange(mesh, rows, dest, **kw)
    assert rounds == 3 and rex.LAUNCHES - before == rounds
    seq, _ = tdp.run_fused_exchange(mesh, rows, dest, pipeline_rounds=False,
                                    **kw)
    before = tre.LAUNCHES
    ring, _ = tdp.run_fused_exchange(mesh, rows, dest, impl="ring", **kw)
    assert tre.LAUNCHES - before == rounds
    cpu, _ = tdp.run_fused_exchange(VirtualMesh(8, "cpu"), rows, dest,
                                    impl="ring", **kw)
    hier, _ = tdp.run_hierarchical_exchange(mesh, Topology((4, 4)), rows,
                                            dest, home, **kw)
    for d in range(8):
        for other in (seq, ring, cpu, hier):
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


def test_read_to_device_on_card(cuda, committed_stage, monkeypatch):
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
    staging = []
    gather = treader._gather

    def spy(parts, row_bytes, out):
        staging.append(out)
        return gather(parts, row_bytes, out)

    monkeypatch.setattr(treader, "_gather", spy)
    keys, payload = treader.read_to_device(chunks, width)
    assert len(staging) == 1 and staging[0].is_pinned()
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


def test_reader_read_to_device_stages_through_the_pool_on_card(
        cuda, committed_stage):
    """``TpuShuffleReader.read_to_device`` with the staging gather (maps
    0 and 2 local, map 1 fetched): the records of every map on the card,
    staged through a lease of the pool given to it, which is back in the
    pool, charged to no tenant, on return."""
    from sparkrdma_tpu_torch.config import TpuShuffleConf
    from sparkrdma_tpu_torch.runtime.pool import BufferPool
    from sparkrdma_tpu_torch.shuffle.reader import TpuShuffleReader
    from sparkrdma_tpu_torch.shuffle.writer import decode_rows

    executors, handle = committed_stage
    width, parts = handle.row_payload_bytes, handle.num_partitions
    conf = TpuShuffleConf(connect_timeout_ms=5000, native_fetch=False)
    reader = TpuShuffleReader(
        executors[0].executor, executors[0].resolver, conf, 1,
        handle.num_maps, 0, parts, width, pool=executors[0].pool)
    pool = BufferPool(conf)
    try:
        keys, payload = reader.read_to_device(pool)
        assert keys.is_cuda and payload.is_cuda
        want = decode_rows(b"".join(
            executors[m % 2].resolver.local_blocks(1, m, 0, parts)
            for m in range(handle.num_maps)), width)
        got = np.concatenate([keys.cpu().numpy().view(np.uint8),
                              payload.cpu().numpy()], axis=1)
        rows = np.concatenate([np.ascontiguousarray(want[0]).view(
            np.uint8).reshape(-1, 8), want[1]], axis=1)
        np.testing.assert_array_equal(got[np.lexsort(got.T[::-1])],
                                      rows[np.lexsort(rows.T[::-1])])
        assert pool.peak_leased_bytes >= got.nbytes
        assert pool.tenant_leased_bytes(reader.fetcher.tenant) == 0
        assert pool.idle_bytes == pool.total_bytes
    finally:
        pool.stop()


@pytest.mark.parametrize("rows_per_round", [0, 1000])
def test_mesh_reduce_fused_on_card_matches_cpu(cuda, committed_stage,
                                               rows_per_round):
    """The fused mesh reduce on the card (``auto``: the ragged kernel once
    per round) equals the same call on the CPU, byte for byte."""
    from sparkrdma_tpu_torch.parallel.mesh import VirtualMesh
    from sparkrdma_tpu_torch.shuffle import mesh_service as tms

    executors, handle = committed_stage
    before = rex.LAUNCHES
    got = tms.run_mesh_reduce_fused(executors, handle, VirtualMesh(8, cuda),
                                    rows_per_round=rows_per_round,
                                    expect_maps=handle.num_maps)
    assert rex.LAUNCHES - before == (2 if rows_per_round else 1)
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
    picks the device plane, the ragged kernel runs (``auto``), no stage
    degrades, no TCP fetcher is built, and every partition equals the
    host truth. With 4 partitions a round's source shard sends to one or
    two destinations (committed outputs are partition-contiguous), which
    the native transport carries with no slot."""
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
        before = rex.LAUNCHES
        out = engine.run(ResultStage(P, reduce_fn, parents=[stage]))
        assert rex.LAUNCHES > before
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
    full launch and the plain version: aligned, and at a view 4 bytes
    into its storage with odd blocks."""
    d = shape[0]
    flat = _blocks((offset + int(np.prod(shape)),), d, cuda)
    x = flat[offset:].view(shape)
    out = torch.full_like(x, -1)
    src, dst = tre._pointer_table(x, out)
    half = d // 2
    tre._launch(x, src[:half], dst, src_begin=0)
    tre._launch(x, src[half:], dst, src_begin=half)
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
assert tre.LAUNCHES == 2, tre.LAUNCHES
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


# -- the ragged all-to-all kernel (the native transport) --------------------

def _ragged_counts(kind: str, d: int, cap: int, seed: int) -> np.ndarray:
    """int32[d, d] counts, each row summing to at most ``cap``: random,
    skewed to shard 0, empty, every source's rows to one receiver (past
    any receive capacity below ``d * cap``), zero rows and columns."""
    rng = np.random.default_rng(seed)
    if kind == "empty":
        return np.zeros((d, d), np.int32)
    if kind == "flood":
        mat = np.zeros((d, d), np.int32)
        mat[:, d // 2] = cap
        return mat
    p = np.full(d, 1.0 / d)
    if kind == "skewed":
        p = np.full(d, 0.1 / max(1, d - 1))
        p[0] = 0.9 if d > 1 else 1.0
    mat = np.stack([rng.multinomial(rng.integers(0, cap + 1), p / p.sum())
                    for _ in range(d)]).astype(np.int32)
    if kind == "holes":
        mat[d // 2] = 0
        mat[:, -1] = 0
    return mat


def _guarded(shape, offset: int, device, fill=SENTINEL):
    """A zeroed ``int32`` tensor of ``shape`` ``offset`` words past a
    16-byte boundary inside a buffer of ``fill`` guard words; returns
    ``(buffer, lo, tensor)``."""
    n = int(np.prod(shape))
    buf = torch.full((2 * GUARD + 4 + n,), fill, dtype=torch.int32,
                     device=device)
    lo = GUARD + (-(buf.data_ptr() // 4 + GUARD)) % 4 + offset
    out = buf[lo:lo + n].view(shape)
    out.zero_()
    return buf, lo, out


def _ragged_check(cuda, d, cap, w, out_cap, mat, src_off=0, dst_off=0,
                  seed=0):
    """One launch into a guarded output against the plain version and the
    gather transport; the data at ``src_off`` words past 16 bytes."""
    from sparkrdma_tpu_torch.parallel.exchange import _gather_exchange

    flat = _blocks((4 + d * cap * w,), seed, cuda)
    pad = (-flat.data_ptr() // 4) % 4
    data = flat[pad + src_off:pad + src_off + d * cap * w].view(d, cap, w)
    m = torch.from_numpy(mat).to(cuda)
    buf, lo, out = _guarded((d, out_cap, w), dst_off, cuda)
    before = rex.LAUNCHES
    got = rex.ragged_all_to_all(data, m, out)
    torch.cuda.synchronize()
    assert got is out and rex.LAUNCHES == before + 1
    want = rex.ragged_all_to_all_plain(data.cpu(), m.cpu(),
                                       torch.zeros((d, out_cap, w),
                                                   dtype=torch.int32))
    case = (d, cap, w, out_cap, src_off, dst_off)
    assert torch.equal(out.cpu(), want), case
    gathered = _gather_exchange(data, m, torch.zeros_like(out))
    assert torch.equal(out, gathered), case
    n = out.numel()
    assert (buf[:lo] == SENTINEL).all() and (buf[lo + n:] == SENTINEL).all()


@pytest.mark.parametrize("kind", ["random", "skewed", "empty", "flood",
                                  "holes"])
@pytest.mark.parametrize("w", [1, 2, 3, 5, 25])
def test_ragged_kernel_matches_plain_and_gather(cuda, kind, w):
    """Every count pattern at every row width, with the receive capacity
    at the send capacity (a flood truncates) and at twice it, data and
    output at offsets 0-3 words past 16 bytes; pairs of a few words and
    of several warp tiles."""
    d = 8
    for cap in (37, 3000):
        mat = _ragged_counts(kind, d, cap, cap + w)
        for out_cap in (cap, 2 * cap):
            for off in range(4):
                _ragged_check(cuda, d, cap, w, out_cap, mat, off,
                              (off + w) % 4, seed=off)


@pytest.mark.parametrize("d", [1, 2, 3, 33, 128])
def test_ragged_kernel_shard_counts(cuda, d):
    """One shard up to ``MAX_SHARDS``: more than 32 pairs a source takes
    several rounds of the warp's pair scan."""
    for kind in ("random", "holes"):
        _ragged_check(cuda, d, 40, 3, 45, _ragged_counts(kind, d, 40, d),
                      1, 2)


def test_ragged_kernel_keeps_rows_past_each_total(cuda):
    """Rows of ``output`` past each receiver's total keep their values."""
    d, cap, w = 8, 100, 3
    data = _blocks((d, cap, w), 1, cuda)
    mat = torch.from_numpy(_ragged_counts("random", d, cap, 2)).to(cuda)
    filler = _blocks((d, 2 * cap, w), 3, cuda)
    got = rex.ragged_all_to_all(data, mat, filler.clone())
    want = rex.ragged_all_to_all_plain(data.cpu(), mat.cpu(), filler.cpu())
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)
    totals = mat.sum(dim=0).cpu()
    for j in range(d):
        assert torch.equal(got[j, int(totals[j]):], filler[j, int(totals[j]):])


def test_ragged_kernel_refuses_bad_arguments(cuda):
    data = torch.zeros((2, 3, 4), dtype=torch.int32, device=cuda)
    mat = torch.zeros((2, 2), dtype=torch.int32, device=cuda)
    out = torch.zeros((2, 5, 4), dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError, match="int32"):
        rex.ragged_all_to_all(data.float(), mat, out)
    with pytest.raises(ValueError, match="D and W"):
        rex.ragged_all_to_all(data, mat, out[:, :, :3].contiguous())
    with pytest.raises(ValueError, match="mat must be"):
        rex.ragged_all_to_all(data, mat.long(), out)
    with pytest.raises(ValueError, match="share a device"):
        rex.ragged_all_to_all(data, mat.cpu(), out)
    with pytest.raises(ValueError, match="contiguous"):
        rex.ragged_all_to_all(data, mat, out.transpose(1, 2).contiguous()
                              .transpose(1, 2))
    big = tre.MAX_SHARDS + 1
    with pytest.raises(ValueError, match="at most"):
        rex.ragged_all_to_all(
            torch.zeros((big, 1, 1), dtype=torch.int32, device=cuda),
            torch.zeros((big, big), dtype=torch.int32, device=cuda),
            torch.zeros((big, 1, 1), dtype=torch.int32, device=cuda))


def test_native_exchange_replays_in_a_cuda_graph(cuda):
    """One ``native`` exchange captured in a CUDA graph (the counts stay
    on the card: nothing is read on the host) and replayed on new rows
    and new counts equals the ``gather`` transport on those inputs."""
    from sparkrdma_tpu_torch.parallel import exchange as tx

    d, cap, w = 8, 5000, 25
    data = _blocks((d, cap, w), 1, cuda)
    mat = torch.from_numpy(_ragged_counts("random", d, cap, 1)).to(cuda)
    out = torch.zeros((d, 2 * cap, w), dtype=torch.int32, device=cuda)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):            # warm-up outside the capture
        tx.ragged_exchange_shard(data, mat, output=out.clone(), impl="native")
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out.zero_()
        got = tx.ragged_exchange_shard(data, mat, output=out, impl="native")
    for seed, kind in ((2, "skewed"), (3, "flood"), (4, "holes")):
        data.copy_(_blocks((d, cap, w), seed, cuda))
        mat.copy_(torch.from_numpy(_ragged_counts(kind, d, cap, seed)))
        before = rex.LAUNCHES
        graph.replay()
        torch.cuda.synchronize()
        assert rex.LAUNCHES == before       # a replay is not a launch call
        want = tx.ragged_exchange_shard(data, mat, output=torch.zeros_like(
            out), impl="gather")
        for g, w_ in zip(got, want):
            assert torch.equal(g, w_), kind


def test_native_exchange_keeps_the_caller_output_storage(cuda):
    """``impl="native"`` writes into the caller's contiguous ``output`` and
    returns it; a non-contiguous ``output`` is copied first and left as it
    was."""
    from sparkrdma_tpu_torch.parallel import exchange as tx

    data = _blocks((8, 64, 4), 5, cuda)
    mat = torch.from_numpy(_ragged_counts("random", 8, 64, 5)).to(cuda)
    out = torch.zeros((8, 64, 4), dtype=torch.int32, device=cuda)
    got = tx.ragged_exchange_shard(data, mat, output=out, impl="native")[0]
    assert got.data_ptr() == out.data_ptr()
    strided = torch.zeros((8, 4, 64), dtype=torch.int32,
                          device=cuda).transpose(1, 2)
    got = tx.ragged_exchange_shard(data, mat, output=strided,
                                   impl="native")[0]
    assert got.data_ptr() != strided.data_ptr() and not strided.any()
    assert torch.equal(got, out)


@pytest.mark.parametrize("d,cap,w,out_cap,src_off,dst_off",
                         [(8, 1000, 25, 2000, 0, 0), (6, 37, 3, 40, 1, 3),
                          (5, 9, 1, 9, 2, 1)])
def test_ragged_range_launches_make_the_full_launch(cuda, d, cap, w,
                                                    out_cap, src_off,
                                                    dst_off):
    """Range launches over sources ``[0, 2)`` and ``[2, d)`` (the second
    with ``src_begin > 0``), their destination bases the shards of one
    guarded local tensor, equal the plain version over all ``d``
    sources: the lands are summed over every source, not the launch's."""
    flat = _blocks((4 + d * cap * w,), d, cuda)
    pad = (-flat.data_ptr() // 4) % 4
    data = flat[pad + src_off:pad + src_off + d * cap * w].view(d, cap, w)
    for kind in ("random", "skewed", "flood", "holes"):
        mat = _ragged_counts(kind, d, cap, cap + w)
        m = torch.from_numpy(mat).to(cuda)
        buf, lo, out = _guarded((d, out_cap, w), dst_off, cuda)
        src = [data.data_ptr() + i * cap * w * 4 for i in range(d)]
        dst = [out.data_ptr() + j * out_cap * w * 4 for j in range(d)]
        before = rex.LAUNCHES
        for s0, s1 in ((0, 2), (2, d)):
            rex._launch_range(data[s0:s1], m, rex._book(d, cuda),
                              src[s0:s1], dst, s0, out_cap)
        torch.cuda.synchronize()
        assert rex.LAUNCHES == before    # only the wrappers count
        want = rex.ragged_all_to_all_plain(
            data.cpu(), m.cpu(), torch.zeros((d, out_cap, w),
                                             dtype=torch.int32))
        assert torch.equal(out.cpu(), want), kind
        n = out.numel()
        assert (buf[:lo] == SENTINEL).all()
        assert (buf[lo + n:] == SENTINEL).all()


_NATIVE_IPC_WORKER = r'''
import sys
import numpy as np
import torch
from sparkrdma_tpu_torch.ops import ragged_exchange as rex
from sparkrdma_tpu_torch.ops import ring_exchange as tre
from sparkrdma_tpu_torch.parallel import exchange, multihost
pid, port = int(sys.argv[1]), sys.argv[2]
multihost.init_multihost(f"127.0.0.1:{port}", 2, pid, local_device_count=4,
                         platform="cuda")
mesh = multihost.global_mesh()
assert exchange.resolve_impl(mesh, "auto") == "native"
lo = pid * 4
for cap, w, out_cap in ((1000, 25, 2000), (7, 3, 5), (64, 1, 200)):
    rng = np.random.default_rng(cap + w)
    glob = torch.from_numpy(rng.integers(-2**31, 2**31, (8, cap, w))
                            .astype(np.int32)).to(mesh.device)
    mat = np.stack([rng.multinomial(rng.integers(0, cap + 1),
                                    np.full(8, 1 / 8)) for _ in range(8)])
    m = torch.from_numpy(mat.astype(np.int32)).to(mesh.device)
    filler = torch.from_numpy(rng.integers(-2**31, 2**31, (8, out_cap, w))
                              .astype(np.int32)).to(mesh.device)
    out = filler[lo:lo + 4].clone()
    got = rex.ragged_all_to_all_peers(glob[lo:lo + 4].contiguous(), m, out,
                                      mesh)
    want = rex.ragged_all_to_all_plain(glob, m, filler.clone())
    torch.cuda.synchronize()
    assert got is out and torch.equal(got, want[lo:lo + 4]), (cap, w)
    # a ring exchange through the same arena, then native again: no
    # stale word of the other transport shows
    blocks = torch.from_numpy(rng.integers(-2**31, 2**31, (8, 8, 3, w))
                              .astype(np.int32)).to(mesh.device)
    ring = tre.ring_all_to_all_peers(blocks[lo:lo + 4].contiguous(),
                                     mesh).clone()
    assert torch.equal(ring, tre.ring_all_to_all_plain(blocks)[lo:lo + 4])
    again = rex.ragged_all_to_all_peers(glob[lo:lo + 4].contiguous(), m,
                                        filler[lo:lo + 4].clone(), mesh)
    assert torch.equal(again, want[lo:lo + 4]), (cap, w)
assert rex.LAUNCHES == 6 and tre.LAUNCHES == 3, (rex.LAUNCHES, tre.LAUNCHES)
assert set(rex.SHAPES) == {(4, 8, 1000, 25, 2000), (4, 8, 7, 3, 5),
                           (4, 8, 64, 1, 200)}
# the global exchange under auto: native, no row through a collective
def refused(*args, **kwargs):
    raise AssertionError("rows went through all_to_all_single")
torch.distributed.all_to_all_single = refused
dest = torch.from_numpy(np.random.default_rng(5).integers(
    0, 8, (4, 300)).astype(np.int32)).to(mesh.device)
rows = torch.arange(4 * 300 * 3, dtype=torch.int32,
                    device=mesh.device).reshape(4, 300, 3) + lo * 900
ex = exchange.make_shuffle_exchange(mesh, "auto", 2)
received, counts, _, overflowed = ex(rows, dest)
assert not overflowed.any() and rex.LAUNCHES == 7
d_np = dest.cpu().numpy()        # the same on both processes (one seed)
for e in range(4):
    want = np.concatenate([
        ((s // 4) * 3600 + (s % 4) * 900
         + np.arange(900).reshape(300, 3))[d_np[s % 4] == lo + e]
        for s in range(8)])
    assert int(counts[e].sum()) == len(want)
    assert np.array_equal(received[e, :len(want)].cpu().numpy(), want), e
multihost.shutdown_multihost()
print("NATIVE_IPC_OK", pid, flush=True)
'''


def test_two_process_native_exchange_on_card(cuda):
    """Two processes share the card, 4 shards each: each range-launches
    the ragged kernel over its own sources into both arenas, and each
    process's ``output`` equals the plain version over the global data
    for its shards (rows past each total kept, a receive truncated at
    ``out_cap``), also after a ring exchange through the same arena;
    ``auto`` over the global mesh is ``native``."""
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
    procs = [subprocess.Popen([sys.executable, "-c", _NATIVE_IPC_WORKER,
                               str(i), port], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, env=env, cwd=root)
             for i in range(2)]
    try:
        outs = [p.communicate(timeout=180)[0].decode() for p in procs]
    finally:
        for p in procs:
            p.kill()
    for i, out in enumerate(outs):
        assert f"NATIVE_IPC_OK {i}" in out, out[-3000:]


# -- the range step's receive merge (ops/run_merge.py) -----------------------

def _merge_on_card(received, counts):
    """The kernel on the card against ``sort_received`` there, byte for
    byte, one launch a call."""
    from sparkrdma_tpu_torch.ops import run_merge as rm
    from sparkrdma_tpu_torch.ops.sort import sort_received

    before = rm.LAUNCHES
    got = rm.merge_runs(received, counts)
    torch.cuda.synchronize()
    assert rm.LAUNCHES == before + 1
    assert torch.equal(got, sort_received(received, counts))
    return got


@pytest.mark.parametrize("kind", ["uniform", "ties", "max_key"])
@pytest.mark.parametrize("case", ["random", "empty_runs", "one_receiver",
                                  "overflow"])
@pytest.mark.parametrize("d,s,w", [(2, 2, 1), (5, 5, 3), (8, 8, 25),
                                   (3, 8, 2), (8, 8, 4), (2, 32, 1)])
def test_run_merge_kernel_is_the_sort(cuda, kind, case, d, s, w):
    """At D = 2, 5, 8 receivers of S runs (3 of 8 as a ``GlobalMesh``
    process holds, 32 runs: a lane each), W = 1, 2, 3, 4, 25 words (the
    kernel's 4-, 8- and 16-byte chunks), buffers of several tiles, keys
    that tie across runs and with the pads' sentinel, empty runs, every
    row to one receiver and a receive past the buffer."""
    from test_torch_run_merge import _counts, _received

    from sparkrdma_tpu_torch.ops import run_merge as rm

    rows = 2 * rm.TILE_ROWS + 37
    counts = _counts(d, s, case, rows, seed=d * s + w)
    received = _received(counts, rows, w, kind, seed=s + w)
    _merge_on_card(received.to(cuda), torch.from_numpy(counts).to(cuda))


def test_run_merge_at_an_unaligned_view(cuda):
    """Rows 4 bytes into their storage: 4-byte chunks at 16-byte rows."""
    from test_torch_run_merge import _counts, _received

    counts = _counts(4, 4, "random", 5000, seed=1)
    received = _received(counts, 5000, 4, "ties", seed=2).to(cuda)
    flat = torch.empty(1 + received.numel(), dtype=torch.int32, device=cuda)
    view = flat[1:].view(received.shape)
    view.copy_(received)
    assert view.data_ptr() % 16
    got = _merge_on_card(view, torch.from_numpy(counts).to(cuda))
    from sparkrdma_tpu_torch.ops import run_merge as rm
    assert torch.equal(got, rm.merge_runs(received, torch.from_numpy(
        counts).to(cuda)))


def test_run_merge_at_terasorts_shape_from_a_range_exchange(cuda,
                                                             monkeypatch):
    """HiBench large's ``[8, 8M, 25]`` receive, counts from the range
    step's own exchange on the card: the step's output is the kernel's,
    and both equal ``sort_received`` of the same buffer."""
    from sparkrdma_tpu_torch.models.terasort import (
        TeraSortConfig,
        make_terasort_step,
    )
    from sparkrdma_tpu_torch.ops import run_merge as rm
    from sparkrdma_tpu_torch.ops.sort import sort_received
    from sparkrdma_tpu_torch.parallel.mesh import VirtualMesh

    kept = []
    inner = rm.merge_runs

    def keep(received, counts):
        kept.append((received, counts))
        return inner(received, counts)
    monkeypatch.setattr(rm, "merge_runs", keep)
    gen = torch.Generator(device=cuda).manual_seed(24)
    rows = torch.randint(-2**31, 2**31, (8, 4_000_000, 25),
                         dtype=torch.int32, device=cuda, generator=gen)
    step = make_terasort_step(VirtualMesh(8), TeraSortConfig(4_000_000))
    before = rm.LAUNCHES
    out, counts, overflowed = step(rows)
    del rows
    assert rm.LAUNCHES == before + 1 and not overflowed.any()
    received, got_counts = kept[0]
    assert received.shape == (8, 8_000_000, 25)
    assert torch.equal(got_counts, counts)
    want = sort_received(received, counts)
    assert torch.equal(out, want)


@pytest.mark.parametrize("case", ["random", "empty_runs", "one_receiver",
                                  "overflow"])
def test_run_merge_stays_in_bounds_on_unsorted_runs(cuda, case):
    """Runs that are not sorted, over several tiles: the kernel makes no
    merge of them, and faults nowhere: every output row is a row of its
    receiver's buffer or a pad row, and the card takes the next call."""
    from test_torch_run_merge import _counts, _rows_of_buffer_or_pads

    from sparkrdma_tpu_torch.ops import run_merge as rm

    rows = 2 * rm.TILE_ROWS + 37
    gen = torch.Generator(device=cuda).manual_seed(7)
    received = torch.randint(-2**31, 2**31, (3, rows, 2), dtype=torch.int32,
                             device=cuda, generator=gen)
    received[:, :, 0] = torch.randint(0, 6, (3, rows), dtype=torch.int32,
                                      device=cuda, generator=gen)
    counts = torch.from_numpy(_counts(3, 8, case, rows, seed=3)).to(cuda)
    got = rm.merge_runs(received, counts)
    torch.cuda.synchronize()
    assert _rows_of_buffer_or_pads(got.cpu(), received.cpu())
    sorted_keys = torch.sort(received, dim=1).values
    _merge_on_card(sorted_keys, torch.tensor([[rows]] * 3, dtype=torch.int32,
                                             device=cuda))


@pytest.mark.parametrize("impl", ["ring", "dense"])
def test_range_step_with_a_slot_pair_past_its_slot(cuda, impl, monkeypatch):
    """A ring or dense range step over 8 shards whose source 0 sends past
    its slot into receiver 1: the merge faults nowhere, the step flags
    the receiver, ``run_terasort`` raises its ``OverflowError``, and the
    card takes the next step."""
    from test_torch_run_merge import (
        _pair_past_its_slot,
        _rows_of_buffer_or_pads,
    )

    from sparkrdma_tpu_torch.models.terasort import (
        TeraSortConfig,
        make_terasort_step,
        run_terasort,
    )
    from sparkrdma_tpu_torch.ops import run_merge as rm
    from sparkrdma_tpu_torch.parallel.mesh import VirtualMesh
    from sparkrdma_tpu_torch.utils.u32 import rows_from_numpy

    d, cap, w = 8, 3000, 3
    mesh = VirtualMesh(d, cuda)
    cfg = TeraSortConfig(cap, payload_words=w - 1)
    rows = _pair_past_its_slot(d, cap, w, seed=11)
    kept = []
    inner = rm.merge_runs

    def keep(received, counts):
        kept.append(received)
        return inner(received, counts)
    monkeypatch.setattr(rm, "merge_runs", keep)
    out, counts, overflowed = make_terasort_step(mesh, cfg, impl)(
        rows_from_numpy(rows, mesh))
    torch.cuda.synchronize()
    assert int(counts[1, 0]) > 2 * cap // d
    assert bool(overflowed[1]) and not bool(overflowed[0])
    assert _rows_of_buffer_or_pads(out.cpu(), kept[0].cpu())
    with pytest.raises(OverflowError, match="out_factor"):
        run_terasort(mesh, cfg, impl, rows=rows)
    fine = _pair_past_its_slot(d, cap, w, seed=11)
    fine[:, 0] = np.random.default_rng(12).integers(0, 2**32, d * cap,
                                                    dtype=np.uint64)
    got, _, _ = run_terasort(mesh, cfg, impl, rows=fine)
    assert (np.diff(got.reshape(d, 2 * cap, w)[:, :, 0].astype(np.int64),
                    axis=1) >= 0).all()
