"""The range step's receive merge (``ops/run_merge.py``): a plain merge
of the runs by searchsorted ranks (``merge_runs_plain``, here) and the
CPU ``range`` step against ``sort_received``'s stable sort of the whole
receive buffer, byte for byte with the pads; the ``fused.merge_bytes``
counter; the ``dest`` step still sorting; a slot pair past its slot
flagged and refused; the host side of the CUDA kernel (the ctypes
signatures and the constants against ``csrc/run_merge.cu``); and the
kernel's two passes emulated in Python lane by lane (the co-ranks of
every tile boundary and each tile's ranks) against ``sort_received``,
and on runs that are not sorted, in bounds. The emulation is a copy of
the kernel's arithmetic: change it with the kernel. The card's half is
in ``tests/test_torch_cuda.py``. This file imports no JAX."""

import ctypes
import re
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from sparkrdma_tpu_torch.models.terasort import TeraSortConfig, run_terasort
from sparkrdma_tpu_torch.ops import run_merge as rm
from sparkrdma_tpu_torch.ops.sort import sort_received
from sparkrdma_tpu_torch.parallel import device_plane
from sparkrdma_tpu_torch.parallel import exchange
from sparkrdma_tpu_torch.parallel.mesh import VirtualMesh
from sparkrdma_tpu_torch.utils import trace
from sparkrdma_tpu_torch.utils.u32 import rows_from_numpy, to_u64

SOURCE = (Path(__file__).resolve().parents[1] / "sparkrdma_tpu_torch"
          / "csrc" / "run_merge.cu").read_text()
MAX_KEY = 2**32 - 1


def run_bounds(recv_counts: torch.Tensor, rows: int):
    """``(starts, ends)`` int64 ``[D, S]``: run s of receiver d at rows
    ``[starts[d, s], ends[d, s])``, the exclusive prefix of the counts and
    its end, both clamped at ``rows``; a negative count counts as 0."""
    counts = recv_counts.to(torch.int64).clamp(min=0)
    ends = torch.cumsum(counts, dim=1)
    return (ends - counts).clamp(max=rows), ends.clamp(max=rows)


def merge_runs_plain(received: torch.Tensor,
                     recv_counts: torch.Tensor) -> torch.Tensor:
    """The merge by ranks, not by a sort: the row of run s at position i
    with key k goes to rank ``i + sum over t < s of searchsorted(run_t, k,
    right=True) + sum over t > s of searchsorted(run_t, k, right=False)``;
    rows past the live total are pad rows, zero with the key word
    0xFFFFFFFF."""
    d, rows = received.shape[0], received.shape[1]
    out = torch.zeros_like(received)
    out[:, :, 0] = -1
    starts, ends = (b.tolist() for b in run_bounds(recv_counts, rows))
    for j in range(d):
        live = ends[j][-1]
        keys = to_u64(received[j, :live, 0])
        runs = [keys[a:b] for a, b in zip(starts[j], ends[j])]
        rank = torch.empty(live, dtype=torch.int64)
        for s, (a, b) in enumerate(zip(starts[j], ends[j])):
            at = torch.arange(b - a)
            for t, run in enumerate(runs):
                if t != s:
                    at += torch.searchsorted(run, runs[s], right=t < s)
            rank[a:b] = at
        out[j, rank] = received[j, :live]
    return out


def _key_draw(rng, kind: str, n: int) -> np.ndarray:
    """u32 keys: uniform, from a tiny range (ties across runs), or with
    a share at the u32 maximum (ties with the pads' sentinel)."""
    if kind == "ties":
        return rng.integers(0, 4, n).astype(np.uint32)
    keys = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    if kind == "max_key":
        keys[rng.random(n) < 0.3] = MAX_KEY
    return keys


def _received(counts: np.ndarray, rows: int, w: int, kind: str,
              seed: int) -> torch.Tensor:
    """A receive buffer as every transport leaves it: receiver d holds
    ``counts[d, s]`` key-sorted rows of run s at the counts' exclusive
    prefix, cut at ``rows``, then zero rows."""
    rng = np.random.default_rng(seed)
    d, s = counts.shape
    buf = np.zeros((d, rows, w), np.uint32)
    for j in range(d):
        at = 0
        for t in range(s):
            c = int(counts[j, t])
            run = rng.integers(0, 2**32, (c, w), dtype=np.uint64).astype(
                np.uint32)
            run[:, 0] = np.sort(_key_draw(rng, kind, c))
            end = min(at + c, rows)
            if end > at:
                buf[j, at:end] = run[:end - at]
            at += c
    return torch.from_numpy(buf.view(np.int32))


def _counts(d: int, s: int, case: str, rows: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if case == "random":
        return rng.integers(0, rows // s + 1, (d, s)).astype(np.int32)
    if case == "empty_runs":
        c = rng.integers(0, 2 * rows // s, (d, s))
        c[rng.random((d, s)) < 0.5] = 0
        c[0] = 0                                 # a receiver with nothing
        return np.minimum(c, rows // s).astype(np.int32)
    if case == "one_receiver":                   # every row to receiver 1
        c = np.zeros((d, s), np.int32)
        c[min(1, d - 1)] = rows // s
        return c
    if case == "overflow":                       # totals past the buffer
        return rng.integers(rows // s, 2 * rows // s + 2, (d, s)).astype(
            np.int32)
    raise ValueError(case)


def _same_bytes(a: torch.Tensor, b: torch.Tensor) -> bool:
    return (a.shape == b.shape and a.dtype == b.dtype
            and a.numpy().tobytes() == b.numpy().tobytes())


CASES = ("random", "empty_runs", "one_receiver", "overflow")


@pytest.mark.parametrize("kind", ["uniform", "ties", "max_key"])
@pytest.mark.parametrize("w", [1, 3, 25])
@pytest.mark.parametrize("d", [2, 5, 8])
def test_plain_is_the_sort_of_the_whole_buffer(d, w, kind):
    rows = 24 * d
    counts = torch.from_numpy(_counts(d, d, "random", rows, seed=d * w))
    received = _received(counts.numpy(), rows, w, kind, seed=d + w)
    want = sort_received(received, counts)
    got = merge_runs_plain(received, counts)
    assert _same_bytes(got, want)
    before = rm.LAUNCHES
    assert _same_bytes(rm.merge_runs(received, counts), want)  # CPU: sort
    assert rm.LAUNCHES == before


@pytest.mark.parametrize("kind", ["uniform", "ties", "max_key"])
@pytest.mark.parametrize("case", CASES)
def test_plain_at_the_count_edges(case, kind):
    """Empty runs and an empty receiver, every row to one receiver, a
    receive past the buffer (runs cut at R, no pads), and a process's
    ``[Dl, G]`` counts of a ``GlobalMesh`` (3 receivers, 8 runs)."""
    for d, s in ((8, 8), (3, 8)):
        rows = 64
        counts = torch.from_numpy(_counts(d, s, case, rows, seed=s + d))
        received = _received(counts.numpy(), rows, 3, kind, seed=s)
        want = sort_received(received, counts)
        assert _same_bytes(merge_runs_plain(received, counts), want)


def test_plain_pads_are_zero_rows_with_the_sentinel_key():
    counts = torch.tensor([[2, 1], [0, 0]], dtype=torch.int32)
    received = _received(counts.numpy(), 5, 3, "uniform", seed=1)
    got = merge_runs_plain(received, counts)
    pad = torch.tensor([-1, 0, 0], dtype=torch.int32)
    assert torch.equal(got[0, 3:], pad.expand(2, 3))
    assert torch.equal(got[1], pad.expand(5, 3))


def test_arguments_are_checked():
    rows = torch.zeros((2, 4, 3), dtype=torch.int32)
    counts = torch.zeros((2, 2), dtype=torch.int32)
    with pytest.raises(TypeError, match="int32"):
        rm.merge_runs(rows.float(), counts)
    with pytest.raises(TypeError, match="int32"):
        rm.merge_runs(rows, counts.long())
    with pytest.raises(ValueError, match=r"\[D, R, W\]"):
        rm.merge_runs(rows[0], counts)
    with pytest.raises(ValueError, match=r"\[D, R, W\]"):
        rm.merge_runs(rows, counts[:1])
    with pytest.raises(ValueError, match=r"\[D, R, W\]"):
        rm.merge_runs(torch.zeros((2, 4, 0), dtype=torch.int32), counts)
    with pytest.raises(ValueError, match="1 to 32 runs"):
        rm.merge_runs(rows, torch.zeros((2, 33), dtype=torch.int32))
    with pytest.raises(ValueError, match="contiguous"):
        rm.merge_runs(torch.zeros((2, 3, 4), dtype=torch.int32).transpose(
            1, 2), counts)
    with pytest.raises(ValueError, match="cuda or cpu"):
        rm.merge_runs(rows.to("meta"), counts.to("meta"))


# -- the range step through the merge ---------------------------------------

def _range_inputs(d: int, w: int, kind: str, cap: int, seed: int):
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, 2**32, (d * cap, w), dtype=np.uint64).astype(
        np.uint32)
    if kind == "one_receiver":      # every key in receiver 1's range
        rows[:, 0] = (2**32 // d) + rng.integers(0, 3, d * cap)
    elif kind == "ties":            # a few keys in each receiver's range
        rows[:, 0] = (rng.integers(0, d, d * cap) * (2**32 // d)
                      + rng.integers(0, 3, d * cap))
    else:
        rows[:, 0] = _key_draw(rng, kind, d * cap)
    return rows


def _captured_step(monkeypatch, d: int, w: int, impl: str,
                   out_factor: int = 2):
    """The CPU range step, each merge call's arguments kept."""
    seen = []
    inner = rm.merge_runs

    def kept(received, recv_counts):
        seen.append((received.clone(), recv_counts.clone()))
        return inner(received, recv_counts)
    monkeypatch.setattr(rm, "merge_runs", kept)
    step = device_plane.make_fused_step(
        VirtualMesh(d, "cpu"), out_factor=out_factor, impl=impl,
        partition="range")
    return step, seen


@pytest.mark.parametrize("kind", ["uniform", "ties", "max_key"])
@pytest.mark.parametrize("w", [1, 3, 25])
@pytest.mark.parametrize("d", [2, 5, 8])
def test_range_step_merges_to_the_sort(monkeypatch, d, w, kind):
    step, seen = _captured_step(monkeypatch, d, w, "native")
    rows = _range_inputs(d, w, kind, 40, seed=d * 10 + w)
    out, counts, overflowed = step(rows_from_numpy(rows, VirtualMesh(
        d, "cpu")))
    assert len(seen) == 1
    received, recv_counts = seen[0]
    assert torch.equal(recv_counts, counts)
    assert _same_bytes(out, sort_received(received, counts))


@pytest.mark.parametrize("impl", ["gather", "native", "ring", "dense"])
@pytest.mark.parametrize("kind", ["ties", "one_receiver"])
def test_range_step_on_every_transport(monkeypatch, impl, kind):
    """Every row to one receiver overflows its buffer (and, on the ring
    and dense transports, each source's slot into it): flagged, and the
    CPU step is the sort of what the transport left."""
    d = 4
    step, seen = _captured_step(monkeypatch, d, 5, impl)
    rows = _range_inputs(d, 5, kind, 32, seed=3)
    out, counts, overflowed = step(rows_from_numpy(rows, VirtualMesh(
        d, "cpu")))
    received, _ = seen[0]
    assert _same_bytes(out, sort_received(received, counts))
    if kind == "one_receiver":
        assert overflowed[1] and counts[1].sum() > out.shape[1]
    else:
        assert not overflowed.any()


def _pair_past_its_slot(d: int, cap: int, w: int, seed: int) -> np.ndarray:
    """Range-step input whose source 0 sends 5/8 of its rows to receiver
    1, past the ring and dense transports' slot of ``2 cap / d`` rows at
    ``d`` >= 4, while every receive stays inside its ``2 cap`` rows."""
    rows = _range_inputs(d, w, "uniform", cap, seed)
    first = rows[:cap, 0]
    part = 2**32 // d
    many = 5 * cap // 8
    first[:many] = part + (first[:many] % part)
    rows[:cap, 0] = first
    return rows


@pytest.mark.parametrize("impl", ["ring", "dense"])
def test_a_slot_pair_past_its_slot_is_flagged_and_refused(monkeypatch,
                                                          impl):
    """The slot transports pack such a pair's runs off their counts'
    offsets: the step flags the receiver, and ``run_terasort`` refuses
    the result with the ``OverflowError`` that asks for more headroom."""
    d, cap, w = 4, 32, 3
    rows = _pair_past_its_slot(d, cap, w, seed=11)
    step, _ = _captured_step(monkeypatch, d, w, impl)
    out, counts, overflowed = step(rows_from_numpy(rows, VirtualMesh(
        d, "cpu")))
    assert counts[1, 0] > 2 * cap // d
    assert bool(overflowed[1]) and int(counts.sum(dim=1).max()) <= 2 * cap
    with pytest.raises(OverflowError, match="out_factor"):
        run_terasort(VirtualMesh(d, "cpu"),
                     TeraSortConfig(cap, payload_words=w - 1), impl,
                     rows=rows)


def test_range_step_over_a_global_mesh_shape(monkeypatch):
    """A ``GlobalMesh`` process's step merges ``[Dl, G]`` counts: the
    exchange of 2 local receivers out of 6 shards, as
    ``ragged_exchange_global`` returns it, through the same merge."""
    g, dl, lo, cap, w = 6, 2, 2, 30, 3
    rng = np.random.default_rng(5)
    data = torch.from_numpy(rng.integers(0, 2**32, (g, cap, w),
                                         dtype=np.uint64).astype(
        np.uint32).view(np.int32))
    keys = np.sort(rng.integers(0, 50, (g, cap)), axis=1).astype(np.int32)
    data[:, :, 0] = torch.from_numpy(keys)
    mat = torch.from_numpy(rng.integers(0, cap // g + 1, (g, g)).astype(
        np.int32))
    output = torch.zeros((dl, 2 * cap, w), dtype=torch.int32)
    received = exchange._gather_exchange(data, mat, output, lo)
    counts = mat.t()[lo:lo + dl].contiguous()
    assert counts.shape == (dl, g)
    want = sort_received(received, counts)
    assert _same_bytes(rm.merge_runs(received, counts), want)


def test_dest_step_still_sorts(monkeypatch):
    calls = {"sort": 0, "merge": 0}
    merge = rm.merge_runs

    def counted_sort(*a, **kw):
        calls["sort"] += 1
        return sort_received(*a, **kw)

    def counted_merge(*a):
        calls["merge"] += 1
        return merge(*a)
    # each caller's own binding of ``ops.sort.sort_received``
    monkeypatch.setattr(device_plane, "sort_received", counted_sort)
    monkeypatch.setattr(rm, "sort_received", counted_sort)
    monkeypatch.setattr(rm, "merge_runs", counted_merge)
    d, cap, w = 4, 16, 3
    mesh = VirtualMesh(d, "cpu")
    rng = np.random.default_rng(7)
    rows = rng.integers(0, 2**32, (d * cap, w), dtype=np.uint64).astype(
        np.uint32)
    dest = torch.from_numpy(rng.integers(-1, d, (d, cap)))
    step = device_plane.make_fused_step(mesh, partition="dest",
                                        impl="native")
    step(rows_from_numpy(rows, mesh), dest)
    assert calls == {"sort": 1, "merge": 0}
    step = device_plane.make_fused_step(mesh, partition="range",
                                        impl="native")
    step(rows_from_numpy(rows, mesh))
    assert calls == {"sort": 2, "merge": 1}   # the CPU merge is the sort


def test_merge_bytes_counts_rows_read_and_written():
    d, w, cap = 4, 25, 30
    mesh = VirtualMesh(d, "cpu")
    step = device_plane.make_fused_step(mesh, impl="native")
    rows = rows_from_numpy(_range_inputs(d, w, "uniform", cap, seed=9),
                           mesh)
    assert not trace.counting()          # the next counted call starts at 0
    with profile(activities=[ProfilerActivity.CPU]):
        out, counts, _ = step(rows)
        step(rows)
    assert trace._counts["fused.merge_bytes"].dtype == torch.int64
    one = (int(counts.sum()) + d * out.shape[1]) * w * 4
    assert trace.counts()["fused.merge_bytes"] == 2 * one
    step(rows)                           # no profiler: not counted
    assert trace.counts()["fused.merge_bytes"] == 2 * one
    with profile(activities=[ProfilerActivity.CPU]):
        step(rows)
    assert trace.counts()["fused.merge_bytes"] == one


# -- the kernel's host side ---------------------------------------------------

def _constant(name: str) -> int:
    match = re.search(rf"constexpr \w+(?: \w+)? {name} = ([^;]+);", SOURCE)
    expr = match.group(1).replace("LL", "").replace("0x7fffffff",
                                                    str(2**31 - 1))
    return int(eval(expr, {"kTileRows": _constant("kTileRows")}
                    if name != "kTileRows" else {}))


def test_constants_match_the_source():
    assert _constant("kTileRows") == rm.TILE_ROWS
    assert _constant("kMaxRuns") == rm.MAX_RUNS
    assert _constant("kMaxRows") == rm.MAX_ROWS


_CTYPES = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p,
           "long long": ctypes.c_longlong, "int": ctypes.c_int,
           "const char*": ctypes.c_char_p}


def test_signatures_match_the_source():
    found = {}
    for ret, name, args in re.findall(
            r'extern "C" ([\w ]+?\*?) (\w+)\(([^)]*)\)', SOURCE):
        types = tuple(_CTYPES[re.sub(r"\s+\w+$", "", a.strip())]
                      for a in args.split(","))
        found[name] = (types, _CTYPES[ret.strip()])
    assert found == rm.SIGNATURES


# -- the kernel's two passes, emulated ----------------------------------------

def _lower_in_run(run: np.ndarray, lo: int, hi: int, v: int, probes: list):
    """``lower_in_run``: the ends first, then the binary search."""
    if lo >= hi:
        return lo
    probes[0] += 1
    if run[lo] >= v:
        return lo
    probes[0] += 1
    if run[hi - 1] < v:
        return hi
    l, h = lo, hi - 1
    while h - l > 1:
        m = l + ((h - l) >> 1)
        probes[0] += 1
        if run[m] < v:
            l = m
        else:
            h = m
    return h


def _corank(keys: list, p: int, lens: list, probes: list):
    """``corank_kernel`` for one boundary: ``keys[s]`` run s's keys,
    ``lens`` their lengths, run s held by lane s; returns the co-ranks in
    run order."""
    runs, live = len(lens), sum(lens)
    search = 0 < p < live
    lo = [n if p >= live else 0 for n in lens]
    hi = [n if search or p >= live else 0 for n in lens]
    cur = 0
    for b in range(31, -1, -1):
        cand = cur | (1 << b)
        m = [_lower_in_run(keys[s], lo[s], hi[s], cand, probes)
             for s in range(runs)]
        if sum(m) <= p:
            cur, lo = cand, m
        else:
            hi = m
    rest = p - sum(lo)
    eq = [h - l for l, h in zip(lo, hi)]
    incl = np.cumsum(eq)
    return [lo[s] + min(eq[s], max(0, rest - (int(incl[s]) - eq[s])))
            for s in range(runs)]


def _emulated_merge(received: torch.Tensor, counts: torch.Tensor,
                    tile: int, probes: list,
                    sorted_runs: bool = True) -> torch.Tensor:
    """Both passes of the kernel at tile size ``tile``: the co-ranks of
    every boundary, then each tile's segments, keys, ranks and copy.
    Asserts the co-ranks monotone inside their runs, the segments
    filling the tile, every read inside the receiver's runs and every
    rank inside the tile, and, on ``sorted_runs``, that no two rows
    share a rank."""
    d, rows, w = received.shape
    runs = counts.shape[1]
    buf = received.numpy()
    out = np.empty_like(buf)
    tiles = -(-rows // tile)
    starts, ends = (b.tolist() for b in run_bounds(counts, rows))
    for j in range(d):
        lens = [b - a for a, b in zip(starts[j], ends[j])]
        keys = [buf[j, a:b, 0].view(np.uint32).astype(np.int64)
                for a, b in zip(starts[j], ends[j])]
        live = sum(lens)
        co = [_corank(keys, min(t * tile, live), lens, probes)
              for t in range(tiles + 1)]
        for t, c in enumerate(co):
            assert sum(c) == min(t * tile, live)
            assert all(0 <= c[s] <= lens[s] for s in range(runs))
            assert t == 0 or all(a <= b for a, b in zip(co[t - 1], c))
        for t in range(tiles):
            p0 = t * tile
            n = min(rows - p0, tile)
            tile_live = max(0, min(live - p0, n))
            first = co[t] if tile_live else [0] * runs
            m = ([co[t + 1][s] - first[s] for s in range(runs)]
                 if tile_live else [0] * runs)
            seg_off = [0] + [int(x) for x in np.cumsum(m)]
            seg_first = [starts[j][s] + first[s] for s in range(runs)]
            assert seg_off[runs] == tile_live
            source = [p0 + i for i in range(tile_live)]
            tkeys, seg_of, row_of = [], [], []
            for i in range(tile_live):
                lo, hi = 0, runs
                while hi - lo > 1:
                    mid = (lo + hi) >> 1
                    if seg_off[mid] <= i:
                        lo = mid
                    else:
                        hi = mid
                row = seg_first[lo] + i - seg_off[lo]
                assert starts[j][lo] <= row < ends[j][lo]
                seg_of.append(lo)
                row_of.append(row)
                tkeys.append(int(buf[j, row, 0].view(np.uint32)))
            ranked = set()
            for i in range(tile_live):
                s, key = seg_of[i], tkeys[i]
                rank = i - seg_off[s]
                for r in range(runs):
                    if r == s:
                        continue
                    lo, hi = seg_off[r], seg_off[r + 1]
                    first_r = lo
                    while lo < hi:
                        mid = (lo + hi) >> 1
                        before = (tkeys[mid] <= key if r < s
                                  else tkeys[mid] < key)
                        if before:
                            lo = mid + 1
                        else:
                            hi = mid
                    rank += lo - first_r
                assert 0 <= rank < tile_live
                if sorted_runs:
                    assert rank not in ranked
                ranked.add(rank)
                source[rank] = row_of[i]
            for row in range(n):
                if row < tile_live:
                    assert 0 <= source[row] < rows
                    out[j, p0 + row] = buf[j, source[row]]
                else:
                    out[j, p0 + row] = 0
                    out[j, p0 + row, 0] = -1
    return torch.from_numpy(out)


def _rows_of_buffer_or_pads(out: torch.Tensor,
                            received: torch.Tensor) -> bool:
    """Each receiver's output rows are rows of its own buffer or pads."""
    pad = np.zeros(out.shape[2], np.int32)
    pad[0] = -1
    for got, buf in zip(out.numpy(), received.numpy()):
        have = {r.tobytes() for r in buf} | {pad.tobytes()}
        if any(r.tobytes() not in have for r in got):
            return False
    return True


@pytest.mark.parametrize("tile", [1, 3, 16, rm.TILE_ROWS])
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("kind", ["uniform", "ties", "max_key"])
def test_emulated_kernel_is_the_plain_merge(kind, case, tile):
    for d, s in ((2, 2), (3, 8), (1, 5)):
        rows = 40
        counts = torch.from_numpy(_counts(d, s, case, rows, seed=d + s))
        received = _received(counts.numpy(), rows, 2, kind, seed=s)
        got = _emulated_merge(received, counts, tile, [0])
        assert _same_bytes(got, sort_received(received, counts))


@pytest.mark.parametrize("runs", [17, rm.MAX_RUNS])
def test_emulated_kernel_with_a_run_a_lane_of_a_whole_warp(runs):
    """Up to 32 runs, one a lane: a group of 32 lanes a boundary."""
    rows = 3 * runs
    counts = torch.from_numpy(_counts(2, runs, "empty_runs", rows,
                                      seed=runs) + 2)
    received = _received(counts.numpy(), rows, 1, "ties", seed=runs)
    got = _emulated_merge(received, counts, 16, [0])
    assert _same_bytes(got, sort_received(received, counts))


@pytest.mark.parametrize("tile", [1, 5, 16])
@pytest.mark.parametrize("case", CASES)
def test_emulated_kernel_stays_in_bounds_on_unsorted_runs(case, tile):
    """Runs that are not sorted, as no caller hands it but a flagged slot
    overflow: co-ranks monotone inside their runs, ranks inside the tile,
    every output row a row of the receiver's buffer or a pad row."""
    rng = np.random.default_rng(tile)
    for d, s in ((2, 3), (3, 8)):
        rows = 40
        counts = torch.from_numpy(_counts(d, s, case, rows, seed=d * s))
        received = torch.from_numpy(rng.integers(
            -2**31, 2**31, (d, rows, 2)).astype(np.int32))
        received[:, :, 0] = torch.from_numpy(rng.integers(
            0, 6, (d, rows)).astype(np.int32))
        got = _emulated_merge(received, counts, tile, [0],
                              sorted_runs=False)
        assert _rows_of_buffer_or_pads(got, received)


@pytest.mark.parametrize("impl", ["ring", "dense"])
def test_emulated_kernel_on_a_slot_pair_past_its_slot(monkeypatch, impl):
    """The receive and counts of a flagged slot overflow, as the range
    step hands them to the merge: in bounds, rows of the buffer or pads."""
    d, cap, w = 4, 32, 3
    step, seen = _captured_step(monkeypatch, d, w, impl)
    rows = _pair_past_its_slot(d, cap, w, seed=11)
    _, counts, overflowed = step(rows_from_numpy(rows, VirtualMesh(
        d, "cpu")))
    assert bool(overflowed[1])
    received, _ = seen[0]
    got = _emulated_merge(received, counts, 8, [0], sorted_runs=False)
    assert _rows_of_buffer_or_pads(got, received)


def test_a_boundary_searches_inside_its_brackets():
    """At TeraSort's shape a receiver's 8 runs hold ~500K uniform keys
    each (one eighth of the u32 range): a boundary costs each lane some
    250 probes, not the 32 x 20 of a search of the whole run a bit."""
    rng = np.random.default_rng(0)
    lo_key = 3 * 2**29
    keys = [np.sort(rng.integers(lo_key, lo_key + 2**29, 500_000))
            for _ in range(8)]
    probes = [0]
    for p in (1, 123_457, 2_000_000, 3_999_999):
        co = _corank(keys, p, [500_000] * 8, probes)
        assert sum(co) == p
        v = np.sort(np.concatenate(keys), kind="stable")[p]
        assert all(np.searchsorted(k, v, "left") <= c
                   <= np.searchsorted(k, v, "right")
                   for k, c in zip(keys, co))
    assert probes[0] / (4 * 8) < 300
