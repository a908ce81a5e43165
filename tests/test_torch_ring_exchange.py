"""The port's ring all-to-all (``sparkrdma_tpu_torch.ops.ring_exchange``)
against the JAX package's Pallas ring kernel, run in interpret mode on
the 8-device CPU mesh, and against the swapaxes oracle. On the CPU the
wrapper takes the plain version; the CUDA kernel itself is checked on
the card (``test_torch_cuda.py`` and ``chip_smoke.py``)."""

import collections
import ctypes
import itertools
import re
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from sparkrdma_tpu.ops.ring_exchange import make_ring_all_to_all
from sparkrdma_tpu_torch.ops import ring_exchange as tre

D = 8


@pytest.fixture(scope="module")
def mesh():
    return Mesh(np.array(jax.devices()[:D]), ("shuffle",))


def _jax_ring(mesh, x: np.ndarray) -> np.ndarray:
    a2a = make_ring_all_to_all(mesh, "shuffle", interpret=True)
    sharding = NamedSharding(mesh, P("shuffle"))
    return np.asarray(jax.block_until_ready(a2a(jax.device_put(x, sharding))))


def _torch(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x).view(np.int32))


def _numpy(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


@pytest.mark.parametrize("c,w", [
    (16, 8), (3, 3), (1, 25),
    # the misaligned widths the card's paths meet (odd C, blocks that are
    # no multiple of 16 bytes: the kernel's load/store body)
    (7, 1), (5, 3), (3, 5), (3, 10), (5, 25)])
def test_plain_matches_pallas_interpret_and_swapaxes(mesh, c, w):
    x = np.random.default_rng(c * 31 + w).integers(
        0, 2**32, size=(D, D, c, w), dtype=np.uint32)
    want = _jax_ring(mesh, x)
    np.testing.assert_array_equal(want, np.swapaxes(x, 0, 1))
    got = tre.ring_all_to_all_plain(_torch(x))
    np.testing.assert_array_equal(_numpy(got), want)


def test_identity_stamps_land_on_the_right_shard(mesh):
    """Shard i's block for shard j carries the stamp i*100+j and must
    arrive as shard j's block from i, intact."""
    x = np.zeros((D, D, 4, 4), dtype=np.uint32)
    for i in range(D):
        for j in range(D):
            x[i, j] = i * 100 + j
    want = _jax_ring(mesh, x)
    got = _numpy(tre.ring_all_to_all(_torch(x)))
    np.testing.assert_array_equal(got, want)
    for j in range(D):
        for i in range(D):
            assert (got[j, i] == i * 100 + j).all(), (i, j)


def test_single_shard_is_identity():
    mesh1 = Mesh(np.array(jax.devices()[:1]), ("shuffle",))
    x = np.arange(16, dtype=np.uint32).reshape(1, 1, 4, 4)
    want = np.asarray(make_ring_all_to_all(mesh1, "shuffle", interpret=True)(
        jax.device_put(x, NamedSharding(mesh1, P("shuffle")))))
    got = _numpy(tre.ring_all_to_all(_torch(x)))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, x)


@pytest.mark.parametrize("d", [2, 3, 5])
def test_cpu_wrapper_is_the_plain_version_and_counts_nothing(d):
    """A CPU tensor takes the plain version; only a kernel launch counts."""
    x = torch.from_numpy(np.random.default_rng(d).integers(
        -2**31, 2**31, size=(d, d, 5, 7), dtype=np.int64).astype(np.int32))
    before = tre.LAUNCHES
    got = tre.ring_all_to_all(x)
    assert tre.LAUNCHES == before
    assert torch.equal(got, x.transpose(0, 1).contiguous())
    assert torch.equal(got, tre.ring_all_to_all_plain(x))


def test_wrapper_refuses_other_devices():
    """Neither a CUDA nor a CPU tensor: raise, never a silent copy."""
    x = torch.empty((2, 2, 3, 3), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        tre.ring_all_to_all(x)


def test_pointer_table_layout():
    """Shard i's source base is ``i * D*C*W*4`` bytes into ``blocks`` and
    its destination base as far into ``out``; the block for shard j lies
    ``j * C*W*4`` bytes past the source base."""
    d, c, w = 3, 5, 7
    blocks = torch.arange(d * d * c * w, dtype=torch.int32).reshape(d, d, c, w)
    out = torch.empty_like(blocks)
    src, dst = tre._pointer_table(blocks, out)
    shard, block = d * c * w * 4, c * w * 4
    assert src == [blocks.data_ptr() + i * shard for i in range(d)]
    assert dst == [out.data_ptr() + i * shard for i in range(d)]
    for i in range(d):
        for j in range(d):
            got = ctypes.string_at(src[i] + j * block, block)
            assert got == blocks[i, j].numpy().tobytes(), (i, j)


def test_pointer_table_refuses_more_than_max_shards():
    ok = torch.zeros((tre.MAX_SHARDS,) * 2 + (1, 1), dtype=torch.int32)
    src, dst = tre._pointer_table(ok, torch.empty_like(ok))
    assert len(src) == len(dst) == tre.MAX_SHARDS
    big = torch.zeros((tre.MAX_SHARDS + 1,) * 2 + (1, 1), dtype=torch.int32)
    with pytest.raises(ValueError, match=f"at most {tre.MAX_SHARDS} shards"):
        tre._pointer_table(big, torch.empty_like(big))


def _range_launch(src, dst, src_begin, block):
    """What the kernel's range launch does with its bases: block (i, j)
    of source shard ``src_begin + i`` goes from ``src[i] + j*block`` to
    ``dst[j] + (src_begin + i)*block``."""
    for i, s in enumerate(src):
        for j, d in enumerate(dst):
            ctypes.memmove(d + (src_begin + i) * block, s + j * block, block)


@pytest.mark.parametrize("dl,procs", [(1, 2), (2, 2), (3, 2), (2, 3)])
def test_peer_pointer_table_range_launches(dl, procs):
    """Each process's table (its ``Dl`` source bases, every process's
    arena shard as a destination base), driven as the kernel drives it
    over the source range ``[rank*Dl, rank*Dl + Dl)``, fills every arena
    with the plain all-to-all of the global blocks."""
    g, c, w = dl * procs, 3, 5
    rng = np.random.default_rng(g)
    glob = torch.from_numpy(rng.integers(
        -2**31, 2**31, (g, g, c, w)).astype(np.int32))
    arenas = [torch.zeros((dl, g, c, w), dtype=torch.int32)
              for _ in range(procs)]
    shard, block = g * c * w * 4, c * w * 4
    for rank in range(procs):
        mine = glob[rank * dl:(rank + 1) * dl].contiguous()
        src, dst = tre._peer_pointer_table(
            mine, [a.data_ptr() for a in arenas])
        assert src == [mine.data_ptr() + i * shard for i in range(dl)]
        assert dst == [arenas[j // dl].data_ptr() + (j % dl) * shard
                       for j in range(g)]
        _range_launch(src, dst, rank * dl, block)
    want = tre.ring_all_to_all_plain(glob)
    for rank, arena in enumerate(arenas):
        assert torch.equal(arena, want[rank * dl:(rank + 1) * dl]), rank


def test_peer_pointer_table_refusals():
    blocks = torch.zeros((2, tre.MAX_SHARDS + 2, 1, 1), dtype=torch.int32)
    with pytest.raises(ValueError, match=f"at most {tre.MAX_SHARDS} shards"):
        tre._peer_pointer_table(blocks, [0] * (tre.MAX_SHARDS // 2 + 1))
    with pytest.raises(ValueError, match="do not make 4 destinations"):
        tre._peer_pointer_table(torch.zeros((2, 4, 1, 1), dtype=torch.int32),
                                [0, 0, 0])


def test_bases_struct_matches_the_kernel_source():
    """``_Bases`` mirrors ``struct Bases`` in the CUDA source: the same
    shard limit, 2 KB, by value in the 4 KB parameter block."""
    assert _cu_constant("kMaxShards") == tre.MAX_SHARDS
    assert ctypes.sizeof(tre._Bases) == 2 * 8 * tre.MAX_SHARDS <= 4096 - 64


_CU = (Path(tre.__file__).resolve().parents[1] / "csrc"
       / "ring_exchange.cu").read_text()
_EXPORTED = dict(
    (m.group(2), (m.group(1), m.group(3)))
    for m in re.finditer(r'extern "C" ([\w ]+?\**) ?(\w+)\(([^)]*)\)', _CU))
# each C type of the launchers' signatures and the ctypes that pass it
# (a byte buffer passes a void pointer)
_C_TYPES = {
    "int": (ctypes.c_int,),
    "long long": (ctypes.c_longlong,),
    "void*": (ctypes.c_void_p, ctypes.c_char_p),
    "const void*": (ctypes.c_void_p, ctypes.c_char_p),
    "void**": (ctypes.POINTER(ctypes.c_void_p),),
    "long long*": (ctypes.POINTER(ctypes.c_longlong),),
    "const char*": (ctypes.c_char_p,),
}


def _c_type(decl: str) -> str:
    """``"const void* bases"`` -> ``"const void*"``."""
    return re.sub(r"\s+\*", "*", re.sub(r"\s*\w+$", "", decl.strip()))


@pytest.mark.parametrize("name", sorted(_EXPORTED))
def test_launch_argtypes_match_the_source(name):
    """The module's ``SIGNATURES`` bind every exported function of the
    CUDA source with its parameters' count and C types and its return
    type: without ``nvcc`` here a mismatch would show only on the card,
    as garbage arguments."""
    assert len(_EXPORTED) == 12 and set(tre.SIGNATURES) == set(_EXPORTED)
    ret, params = _EXPORTED[name]
    decls = [p for p in params.split(",") if p.strip() and p.strip() != "void"]
    argtypes, restype = tre.SIGNATURES[name]
    assert len(argtypes) == len(decls), (name, decls)
    for decl, ctype in zip(decls, argtypes):
        assert ctype in _C_TYPES[_c_type(decl)], (name, decl, ctype)
    assert restype in _C_TYPES[ret.replace(" *", "*")], (name, ret)


def _cu_constant(name: str) -> int:
    found = re.search(rf"constexpr int {name} = (\d+);", _CU)
    assert found, name
    return int(found.group(1))


def _interior_of(src: int, dst: int, n: int):
    """``interior_of`` in the CUDA source, on word addresses (a word
    address is 16-byte aligned when it is a multiple of 4)."""
    head, r, nvec = (4 - dst % 4) % 4, 0, 0
    if head >= n:
        return n, 0, 0
    r = (src + head) % 4
    if r > head:
        head += 4
    room = n - head - (4 - r if r else 0)
    if head > n:
        head = n
    elif room >= 4:
        nvec = room // 4
    return head, nvec, r


def _copy_pair_tile(mem: list, src: int, dst: int, n: int, tile: int,
                    writes: collections.Counter) -> None:
    """``copy_pair_tile`` in the CUDA source: tile ``tile`` of one pair's
    copy of ``n`` words from word address ``src`` to ``dst`` over the
    word memory ``mem``, lane by lane: tile 0's scalar words,
    ``copy_tile``'s vector loads, warp shuffles and stores. Checks that
    every load and store lies inside the pair's words (16-byte ones
    aligned) and counts each destination word written in ``writes``."""
    unroll = _cu_constant("kLdstUnroll")
    tile_vecs = 32 * unroll
    head, nvec, r = _interior_of(src, dst, n)

    def load(a, words=1):
        assert src <= a and a + words <= src + n, (a, words)
        assert words == 1 or a % 4 == 0, a
        return mem[a:a + words]

    def store(a, vals):
        assert dst <= a and a + len(vals) <= dst + n, (a, len(vals))
        assert len(vals) == 1 or a % 4 == 0, a
        mem[a:a + len(vals)] = vals
        writes.update(range(a, a + len(vals)))

    words = [n] * 32
    if tile == 0:
        words = [lane if lane < head else head + 4 * nvec + lane - head
                 for lane in range(32)]
    scalars = [load(src + w) if w < n else None for w in words]
    first = tile * tile_vecs
    if first < nvec:
        s4, d4 = src + head - r + 4 * first, dst + head + 4 * first
        left = nvec - first
        outs = min(left, tile_vecs)
        loads = outs if r == 0 else min(left, tile_vecs) + 1
        cur = [[load(s4 + 4 * (u * 32 + lane), 4)
                if u * 32 + lane < loads else [0] * 4
                for u in range(unroll)] for lane in range(32)]
        ext = load(s4 + 4 * tile_vecs, 4) if r and tile_vecs < loads \
            else [0] * 4
        for u in range(unroll):
            give = [(cur[0][u + 1] if u + 1 < unroll else ext)
                    if lane == 0 else cur[lane][u] for lane in range(32)]
            for lane in range(32):
                i = u * 32 + lane
                out = cur[lane][u][r:] + give[(lane + 1) % 32][:r]
                if i < outs:
                    store(d4 + 4 * i, out)
    for w, val in zip(words, scalars):
        if w < n:
            store(dst + w, val)


def _run_ldst_pair(mem: list, src: int, dst: int, n: int) -> dict:
    """One pair of ``ring_ldst_kernel`` over the word memory ``mem``:
    every tile of the grid of ``launch_ldst``, each as
    ``_copy_pair_tile``. Returns the number of writes to each
    destination word and the head and tail."""
    warps = _cu_constant("kLdstThreads") // 32
    tile_vecs = 32 * _cu_constant("kLdstUnroll")
    head, nvec, _ = _interior_of(src, dst, n)
    tiles = -(-(n // 4) // tile_vecs)
    groups = -(-tiles // warps) if tiles else 1
    writes = collections.Counter()
    for tile in range(groups * warps):
        _copy_pair_tile(mem, src, dst, n, tile, writes)
    return {"writes": writes, "head": head, "tail": n - head - 4 * nvec}


@pytest.mark.parametrize("src_off", range(4))
@pytest.mark.parametrize("dst_off", range(4))
def test_load_store_cut_covers_the_pair(src_off, dst_off):
    """The load/store body's cut of one pair, emulated word by word from
    the CUDA source's arithmetic for a source and a destination
    ``src_off``/``dst_off`` words past a 16-byte boundary: every 16-byte
    load and store lies inside the pair's bytes, every destination word
    is written exactly once with its source word, and head and tail are
    at most 15 words together."""
    for n in (1, 3, 4, 7, 15, 16, 17, 100, 513, 2049):
        src, dst = 64 + src_off, 64 + 4 * (n // 4 + 4) + dst_off
        mem = [-1] * (dst + n + 64)
        mem[src:src + n] = range(1000, 1000 + n)
        got = _run_ldst_pair(mem, src, dst, n)
        assert got["writes"] == collections.Counter(range(dst, dst + n)), n
        assert mem[dst:dst + n] == list(range(1000, 1000 + n)), n
        assert mem[:src] == [-1] * src and mem[dst + n:] == [-1] * 64, n
        assert got["head"] + got["tail"] <= 15, (n, got["head"], got["tail"])


# -- the ragged all-to-all's grid, emulated -------------------------------

RAGGED_FAULTS = (None, "scalar_pairs", "no_pair_tiles", "no_truncation",
                 "local_lands")


def _run_ragged(mem: list, src_bases, dst_bases, src_begin: int, mat,
                cap: int, out_rows: int, w: int,
                fault=None) -> collections.Counter:
    """``launch_ragged`` in the CUDA source over the word memory ``mem``:
    the range launch over sources ``[src_begin, src_begin +
    len(src_bases))`` of ``G = len(dst_bases)``, source ``k``'s ``cap``
    rows of ``w`` words at word address ``src_bases[k]`` and receiver
    ``j``'s ``out_rows`` rows at ``dst_bases[j]``.
    ``ragged_book_kernel``'s counts, starts and lands over the whole
    ``[G, G]`` matrix, then every warp tile of ``ragged_ldst_kernel``'s
    grid (tile groups, the launch's sources): warp ``y`` reads book row
    ``src_begin + y``, finds its pair by the warp scan of 32 pairs' tile
    counts at a time and copies it as ``_copy_pair_tile`` to
    ``dst_bases[j] + land * w``. Returns the writes to each word.
    ``fault`` plants a mistake: a pair of scalar words only given no
    tile, a grid without its tile a pair, no clamp at ``out_rows``, lands
    summed over the launch's own sources only."""
    g = len(mat)
    warps = _cu_constant("kLdstThreads") // 32
    tile_vecs = 32 * _cu_constant("kLdstUnroll")
    counts = [[max(int(c), 0) for c in row] for row in mat]
    starts = [list(itertools.accumulate([0] + row[:-1])) for row in counts]
    first = src_begin if fault == "local_lands" else 0
    lands = [[sum(counts[s][j] for s in range(first, i)) for j in range(g)]
             for i in range(g)]
    tiles_max = (cap * w // 4 + tile_vecs - 1) // tile_vecs
    if fault != "no_pair_tiles":
        tiles_max += g
    groups = -(-tiles_max // warps)
    writes = collections.Counter()
    for y, shard in enumerate(src_bases):
        i = src_begin + y
        for tile in range(groups * warps):
            before = 0
            for j0 in range(0, g, 32):
                lanes = []
                for j in range(j0, j0 + 32):
                    n = src_off = dst = tiles = 0
                    if j < g:
                        rows = min(counts[i][j], cap - starts[i][j])
                        if fault != "no_truncation":
                            rows = min(rows, out_rows - lands[i][j])
                        if rows > 0:
                            n, src_off = rows * w, starts[i][j] * w
                            dst = dst_bases[j] + lands[i][j] * w
                            nvec = _interior_of(shard + src_off, dst, n)[1]
                            tiles = -(-nvec // tile_vecs)
                            if fault != "scalar_pairs":
                                tiles = max(tiles, 1)
                    lanes.append((n, src_off, dst, tiles))
                incl = list(itertools.accumulate(t for *_, t in lanes))
                if tile < before + incl[31]:
                    owner = next(lane for lane in range(32)
                                 if before + incl[lane] > tile)
                    n, src_off, dst, tiles = lanes[owner]
                    _copy_pair_tile(mem, shard + src_off, dst, n,
                                    tile - before - (incl[owner] - tiles),
                                    writes)
                    break
                before += incl[31]
    return writes


def _ragged_mats(rng, d: int, cap: int):
    """Count matrices of the emulated cases: random rows, a zero row and
    a zero column, one pair holding a source's every row, a pair of 0
    rows beside full ones, and a receiver flooded past its capacity."""
    rand = np.stack([rng.multinomial(rng.integers(0, cap + 1),
                                     np.full(d, 1.0 / d)) for _ in range(d)])
    zero = rand.copy()
    zero[d // 2] = 0
    zero[:, d - 1] = 0
    whole = np.zeros((d, d), np.int64)
    whole[:, (np.arange(d) + 1) % d] = np.eye(d, dtype=np.int64) * cap
    flood = np.zeros((d, d), np.int64)
    flood[:, 0] = cap
    return {"random": rand, "zero_row_col": zero, "whole_pair": whole,
            "flood": flood}


def _ragged_case(d: int, cap: int, out_rows: int, w: int, mat,
                 src_off: int, dst_off: int, fault=None,
                 procs: int = 1) -> None:
    """One emulated exchange against ``ragged_all_to_all_plain`` over the
    ``d`` global sources: ``procs`` processes of ``d // procs`` shards,
    each with its sources and its receive arena in a region of one flat
    word memory (sources ``src_off`` and arenas ``dst_off`` words past a
    16-byte boundary, guard words between), each making its range launch
    with every arena's shards as destination bases (``procs = 1``: the
    one-card launch). Each arena word written at most once (and those the
    plain version writes, once each), every arena equal to the plain
    version's rows for its shards, nothing outside the arenas written."""
    from sparkrdma_tpu_torch.ops.ragged_exchange import (
        ragged_all_to_all_plain)

    dl = d // procs
    rng = np.random.default_rng(d * 1000 + cap * 10 + w)
    src = rng.integers(-2**31, 2**31, (d, cap, w)).astype(np.int32)
    init = rng.integers(-2**31, 2**31, (d, out_rows, w)).astype(np.int32)
    addr, datas, outs = 64, [], []
    for regions, off, rows in ((datas, src_off, cap),
                               (outs, dst_off, out_rows)):
        for _ in range(procs):
            regions.append(addr + off)
            addr = -(-(addr + off + dl * rows * w) // 4) * 4 + 64
    mem = [-7] * addr
    span = dl * out_rows * w
    for p in range(procs):
        part = slice(p * dl, (p + 1) * dl)
        mem[datas[p]:datas[p] + dl * cap * w] = src[part].reshape(-1).tolist()
        mem[outs[p]:outs[p] + span] = init[part].reshape(-1).tolist()
    before = list(mem)
    dst_bases = [outs[j // dl] + (j % dl) * out_rows * w for j in range(d)]
    writes = collections.Counter()
    for p in range(procs):
        src_bases = [datas[p] + i * cap * w for i in range(dl)]
        writes.update(_run_ragged(mem, src_bases, dst_bases, p * dl, mat,
                                  cap, out_rows, w, fault))
    want = ragged_all_to_all_plain(
        torch.from_numpy(src), torch.from_numpy(np.asarray(mat, np.int32)),
        torch.from_numpy(init.copy())).numpy()
    arena = set()
    for p in range(procs):
        part = slice(p * dl, (p + 1) * dl)
        assert mem[outs[p]:outs[p] + span] == want[part].reshape(-1).tolist()
        arena.update(range(outs[p], outs[p] + span))
        written = (want[part] != init[part]).reshape(-1)
        assert all(writes[outs[p] + k] for k in np.flatnonzero(written))
    assert all(a in arena for a in writes)
    assert max(writes.values(), default=1) == 1
    assert all(mem[a] == before[a] for a in range(len(mem))
               if a not in arena)


@pytest.mark.parametrize("src_off", range(4))
@pytest.mark.parametrize("dst_off", range(4))
def test_ragged_grid_covers_every_pair(src_off, dst_off):
    """The ragged kernel's grid and pair search, emulated word by word
    from the CUDA source's arithmetic with ``data`` and ``out``
    ``src_off``/``dst_off`` words past a 16-byte boundary, at W = 1, 2,
    3, 5, 25 (so the pairs' runs start at every offset 0-3 words on
    both sides) and D = 8: zero rows and columns, a pair of every row,
    a receiver flooded past its capacity (truncated), and a pair of 2
    KB and more (several tiles)."""
    d = 8
    rng = np.random.default_rng(src_off * 4 + dst_off)
    for w in (1, 2, 3, 5, 25):
        cap = 48 if w == 25 else 40
        for name, mat in _ragged_mats(rng, d, cap).items():
            for out_rows in (cap, 2 * cap + 1):
                _ragged_case(d, cap, out_rows, w, mat, src_off, dst_off)


@pytest.mark.parametrize("d,cap,w", [(1, 9, 3), (3, 17, 5), (40, 6, 2)])
def test_ragged_grid_other_shard_counts(d, cap, w):
    """One shard, three, and forty (two rounds of the warp's 32-pair
    scan)."""
    rng = np.random.default_rng(d)
    for name, mat in _ragged_mats(rng, d, cap).items():
        _ragged_case(d, cap, cap, w, mat, 1, 3)


@pytest.mark.parametrize("procs", [1, 2, 3])
@pytest.mark.parametrize("dl", [1, 2, 4])
def test_ragged_range_launches_make_the_global_exchange(procs, dl):
    """The range form across processes: ``procs`` processes of ``dl``
    shards, each launching over its own sources with every process's
    arena shards as destination bases, together write what the plain
    version gives over the global data, at W = 1, 3, 25, source and
    arena offsets of 0-3 words, under every count pattern and a receive
    capacity at and past the send capacity."""
    d = procs * dl
    rng = np.random.default_rng(procs * 10 + dl)
    for w, (src_off, dst_off) in zip((1, 3, 25, 3), ((0, 0), (1, 3), (3, 2),
                                                      (2, 1))):
        cap = 20 if w == 25 else 13
        for name, mat in _ragged_mats(rng, d, cap).items():
            for out_rows in (cap, 2 * cap + 1):
                _ragged_case(d, cap, out_rows, w, mat, src_off, dst_off,
                             procs=procs)


@pytest.mark.parametrize("fault", RAGGED_FAULTS[1:])
def test_ragged_emulation_catches_planted_faults(fault):
    """Each planted mistake in the emulated kernel fails some case of
    the emulation's own checks, one card or two processes, so those
    checks can see such a fault."""
    rng = np.random.default_rng(5)
    failed = 0
    for w in (1, 3, 25):
        for name, mat in _ragged_mats(rng, 8, 40).items():
            for procs in (1, 2):
                try:
                    _ragged_case(8, 40, 40, w, mat, 1, 2, fault, procs)
                except AssertionError:
                    failed += 1
    assert failed > 0, fault


def test_ragged_peer_pointer_table():
    """Each process's table (its ``Dl`` source bases, ``cap*W*4`` bytes
    apart, and every process's arena shard, ``out_cap*W*4`` bytes apart,
    as a destination base), read back through ``ctypes``; driven as the
    range launch drives it (pair ``(i, j)`` at its land over all
    sources), every arena holds the plain version of the global data."""
    from sparkrdma_tpu_torch.ops import ragged_exchange as rex

    procs, dl, cap, out_cap, w = 3, 2, 5, 7, 3
    g = procs * dl
    rng = np.random.default_rng(3)
    glob = torch.from_numpy(rng.integers(-2**31, 2**31, (g, cap, w))
                            .astype(np.int32))
    mat = np.stack([rng.multinomial(rng.integers(0, cap + 1),
                                    np.full(g, 1.0 / g)) for _ in range(g)])
    arenas = [torch.zeros((dl, out_cap, w), dtype=torch.int32)
              for _ in range(procs)]
    starts = np.cumsum(mat, axis=1) - mat
    lands = np.cumsum(mat, axis=0) - mat
    row = w * 4
    for rank in range(procs):
        mine = glob[rank * dl:(rank + 1) * dl].contiguous()
        src, dst = rex._ragged_peer_pointer_table(
            mine, [a.data_ptr() for a in arenas], out_cap)
        assert src == [mine.data_ptr() + i * cap * row for i in range(dl)]
        assert dst == [arenas[j // dl].data_ptr() + (j % dl) * out_cap * row
                       for j in range(g)]
        for i in range(dl):
            assert ctypes.string_at(src[i], cap * row) == \
                mine[i].numpy().tobytes()
            s = rank * dl + i
            for j in range(g):
                land, start = int(lands[s, j]), int(starts[s, j])
                rows = min(int(mat[s, j]), out_cap - land)
                if rows > 0:
                    ctypes.memmove(dst[j] + land * row, src[i] + start * row,
                                   rows * row)
    want = rex.ragged_all_to_all_plain(
        glob, torch.from_numpy(mat.astype(np.int32)),
        torch.zeros((g, out_cap, w), dtype=torch.int32))
    for rank, arena in enumerate(arenas):
        assert torch.equal(arena, want[rank * dl:(rank + 1) * dl]), rank
    big = torch.zeros((2, 1, 1), dtype=torch.int32)
    with pytest.raises(ValueError, match=f"at most {tre.MAX_SHARDS} shards"):
        rex._ragged_peer_pointer_table(big, [0] * (tre.MAX_SHARDS // 2 + 1),
                                       1)
