"""The stable partition by destination under ``group_by_destination``
(``ops/dest_partition.py``): its plain version against a numpy stable
argsort and count, ``group_by_destination`` on it, the host side of the
CUDA kernel (the ctypes signatures and the constants against
``csrc/dest_partition.cu``) and the kernel's three passes emulated warp by
warp at its own tile size; then, marked ``cuda``, the kernel against its
plain version on the card, byte for byte, at q95's shapes and at the
edges, its launches, ``group_by_destination`` on the card against the
JAX package's grouping of the same arrays (``grouping_inputs.py``), and
the ``exchange.group`` span around the row gather. The emulation is a copy of the kernel's arithmetic: change it with
the kernel. This file imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_dest_partition.py
"""

import ctypes
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import grouping_inputs
from sparkrdma_tpu_torch.ops import dest_partition as dp
from sparkrdma_tpu_torch.ops.ring_exchange import MAX_SHARDS
from sparkrdma_tpu_torch.parallel import exchange

_CU = (Path(__file__).resolve().parents[1] / "sparkrdma_tpu_torch" / "csrc"
       / "dest_partition.cu").read_text()


def _constant(name: str) -> int:
    found = re.search(rf"constexpr (?:int|long long) {name} = (0x[0-9a-f]+|"
                      rf"\d+)(?:LL)?;", _CU)
    assert found, name
    return int(found.group(1), 0)


TILE = _constant("kTileRows")
THREADS = _constant("kThreads")
MAX_BUCKETS = _constant("kMaxBuckets")

# (shards, rows a shard, partitions, dtype, kind)
EDGES = {
    "int32": (3, 2 * TILE + 77, 8, torch.int32, "random"),
    "int64": (3, 2 * TILE + 77, 8, torch.int64, "random"),
    "p1": (2, TILE + 33, 1, torch.int32, "random"),
    "p128": (2, TILE + 5, 128, torch.int32, "random"),
    "empty": (4, 0, 8, torch.int32, "random"),
    "no_shards": (0, 10, 8, torch.int32, "random"),
    "below_a_tile": (3, 100, 8, torch.int64, "random"),
    "one_tile": (2, TILE, 8, torch.int32, "random"),
    "shard_all_pads": (3, TILE + 1000, 8, torch.int32, "shard_all_pads"),
    "one_bucket": (2, TILE + 999, 8, torch.int64, "one_bucket"),
    "wide_int64": (2, 3000, 8, torch.int64, "wide"),
}


def _dest(d: int, n: int, p: int, dtype, kind: str, seed: int = 0
          ) -> torch.Tensor:
    """Destinations of one case: uniform over ``[-3, p + 3)`` (so some
    negative and some past the last partition), a shard all pads, every
    row to one partition, or int64 values far outside int32."""
    rng = np.random.default_rng(seed)
    dest = rng.integers(-3, p + 3, size=(d, n))
    if kind == "shard_all_pads":
        dest[1] = rng.choice([-1, p, p + 7], size=n)
    elif kind == "one_bucket":
        dest[:] = min(3, p - 1)
    elif kind == "wide":
        dest = rng.choice([-2**40, -1, 0, 1, 5, 7, 2**33, 2**62], size=(d, n))
    return torch.from_numpy(dest).to(dtype)


def _numpy_partition(dest: torch.Tensor, p: int):
    """``(order, totals)`` by numpy: a stable argsort of the destinations
    with the pads mapped to ``p``, and a count of each bucket."""
    host = dest.to(torch.int64).numpy()
    b = np.where((host < 0) | (host >= p), p, host)
    order = np.argsort(b, axis=1, kind="stable")
    totals = np.stack([np.bincount(row, minlength=p + 1) for row in b]
                      ) if len(b) else np.zeros((0, p + 1), np.int64)
    return order, totals.astype(np.int32)


@pytest.mark.parametrize("case", sorted(EDGES))
def test_plain_is_a_stable_argsort_and_a_count(case):
    d, n, p, dtype, kind = EDGES[case]
    dest = _dest(d, n, p, dtype, kind, seed=len(case))
    order, totals = dp.dest_partition_plain(dest, p)
    want_order, want_totals = _numpy_partition(dest, p)
    assert order.dtype == torch.int64 and totals.dtype == torch.int32
    assert order.shape == (d, n) and totals.shape == (d, p + 1)
    np.testing.assert_array_equal(order.numpy(), want_order)
    np.testing.assert_array_equal(totals.numpy(), want_totals)


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_group_by_destination_groups_rows_and_counts(dtype):
    d, n, p = 3, 3000, 5
    dest = _dest(d, n, p, dtype, "random", seed=4)
    data = torch.arange(d * n * 3, dtype=torch.int32).reshape(d, n, 3)
    grouped, counts = exchange.group_by_destination(data, dest, p)
    order, totals = _numpy_partition(dest, p)
    want = np.stack([data[j].numpy()[order[j]] for j in range(d)])
    np.testing.assert_array_equal(grouped.numpy(), want)
    assert counts.dtype == torch.int32
    np.testing.assert_array_equal(counts.numpy(), totals[:, :p])


def test_the_kernel_holds_every_transports_shard_count():
    assert dp.MAX_PARTITIONS >= MAX_SHARDS


# -- the kernel's host side ---------------------------------------------------

def test_constants_match_the_source():
    assert TILE == dp.TILE_ROWS
    assert MAX_BUCKETS - 1 == dp.MAX_PARTITIONS
    assert _constant("kMaxRows") == dp.MAX_ROWS
    assert TILE % THREADS == 0 and (TILE // (THREADS // 32)) % 32 == 0


_C_TYPES = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p,
            "long long": ctypes.c_longlong, "int": ctypes.c_int,
            "const char*": ctypes.c_char_p}


def test_signatures_match_the_source():
    found = {}
    for ret, name, args in re.findall(
            r'extern "C" ([\w ]+?\*?) (\w+)\(([^)]*)\)', _CU):
        types = tuple(_C_TYPES[re.sub(r"\s+\w+$", "", a.strip())]
                      for a in args.split(","))
        found[name] = (types, _C_TYPES[ret.strip()])
    assert found == dp.SIGNATURES


@pytest.mark.parametrize("dest,p,error", [
    (torch.zeros((2, 4), dtype=torch.int16), 4, TypeError),
    (torch.zeros((2, 4)), 4, TypeError),
    (torch.zeros((8,), dtype=torch.int32), 4, ValueError),
    (torch.zeros((2, 4), dtype=torch.int32), 0, ValueError),
    (torch.zeros((2, 4), dtype=torch.int32), 256, ValueError),
])
def test_refuses_what_the_kernel_does_not_take(dest, p, error):
    with pytest.raises(error):
        dp._check(dest, p)


# -- the kernel's three passes, emulated --------------------------------------

def _groups(bucket: np.ndarray, first: int, end: int, p: int):
    """A warp's walk over rows ``[first, end)``: each 32-row group's rows
    and buckets, ``p + 1`` past ``end``."""
    for r0 in range(first, end, 32):
        rows = np.arange(r0, r0 + 32)
        yield rows, np.where(rows < end, bucket[np.minimum(rows, end - 1)],
                             p + 1)


LANES = np.arange(32)


def _peers(b: np.ndarray, p: int) -> np.ndarray:
    """``peers_of``: one ballot a bit of the bucket (``bits_of``: the bit
    length of ``p + 1``), each lane keeping the lanes that agree with it;
    ``[32, 32]`` bool, row l lane l's mask."""
    peers = np.full(32, 0xFFFFFFFF, np.int64)
    for i in range((p + 1).bit_length()):
        on = (b >> i) & 1
        ballot = int((on << LANES).sum())
        peers &= np.where(on == 1, ballot, ~ballot & 0xFFFFFFFF)
    return (peers[:, None] >> LANES) & 1 == 1


def _count_chunk(bucket, first, end, p, hist) -> None:
    """``count_chunk``: the lowest lane of each bucket's peers adds their
    number."""
    for _, b in _groups(bucket, first, end, p):
        peers = _peers(b, p)
        leader = peers.argmax(axis=1) == LANES
        live = leader & (b <= p)
        hist[b[live]] += peers.sum(axis=1)[live]


def _emulated(dest: torch.Tensor, p: int):
    """``count_kernel``, ``scan_kernel`` and ``place_kernel`` block by
    block and warp by warp: ``(order, totals)``."""
    d, n = dest.shape
    buckets, warps = p + 1, THREADS // 32
    chunk = TILE // warps
    tiles = -(-n // TILE)
    host = dest.to(torch.int64).numpy()
    order = np.full((d, n), -1, np.int64)
    totals = np.zeros((d, buckets), np.int32)
    if n == 0:                                      # no launch
        return torch.from_numpy(order), torch.from_numpy(totals)
    for j in range(d):
        bucket = np.where((host[j] < 0) | (host[j] >= p), p, host[j])
        table = np.zeros((buckets, tiles), np.int64)
        for t in range(tiles):                      # count pass
            hist = np.zeros((warps, MAX_BUCKETS), np.int64)
            for w in range(warps):
                first = t * TILE + w * chunk
                _count_chunk(bucket, first, min(first + chunk, n), p,
                             hist[w])
            table[:, t] = hist[:, :buckets].sum(axis=0)
        flat = table.reshape(-1)                    # scan pass
        starts = (np.cumsum(flat) - flat).reshape(buckets, tiles)
        for b in range(buckets):
            end = starts[b + 1, 0] if b + 1 < buckets else n
            totals[j, b] = end - starts[b, 0]
        for t in range(tiles):                      # place pass
            start = np.zeros((warps, MAX_BUCKETS), np.int64)
            for w in range(warps):
                first = t * TILE + w * chunk
                _count_chunk(bucket, first, min(first + chunk, n), p,
                             start[w])
            run = starts[:, t].copy()
            for w in range(warps):
                c = start[w, :buckets].copy()
                start[w, :buckets] = run
                run += c
            for w in range(warps):
                first = t * TILE + w * chunk
                for rows, b in _groups(bucket, first, min(first + chunk, n),
                                       p):
                    peers = _peers(b, p)
                    rank = np.tril(peers, -1).sum(axis=1)
                    live = b <= p
                    at = start[w, b[live]] + rank[live]
                    assert (order[j, at] == -1).all()  # each place once
                    order[j, at] = rows[live]
                    leader = live & (rank == 0)
                    start[w, b[leader]] += peers.sum(axis=1)[leader]
    return torch.from_numpy(order), torch.from_numpy(totals)


@pytest.mark.parametrize("case", sorted(EDGES))
def test_emulated_kernel_is_the_plain_partition(case):
    d, n, p, dtype, kind = EDGES[case]
    dest = _dest(d, n, p, dtype, kind, seed=len(case))
    want_order, want_totals = dp.dest_partition_plain(dest, p)
    got_order, got_totals = _emulated(dest, p)
    assert torch.equal(got_order, want_order)
    assert torch.equal(got_totals, want_totals)


# -- on the card --------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _same_on_card(dest: torch.Tensor, p: int, device) -> None:
    """The kernel against its plain version on the card, byte for byte,
    in one launch of its three passes (none for an empty partition)."""
    dest = dest.to(device)
    before = dp.LAUNCHES
    order, totals = dp.dest_partition(dest, p)
    want_order, want_totals = dp.dest_partition_plain(dest, p)
    torch.cuda.synchronize()
    assert dp.LAUNCHES == before + (1 if dest.numel() else 0)
    assert order.dtype == torch.int64 and totals.dtype == torch.int32
    assert torch.equal(order, want_order)
    assert torch.equal(totals, want_totals)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(EDGES))
def test_kernel_equals_plain_at_the_edges(cuda, case):
    d, n, p, dtype, kind = EDGES[case]
    _same_on_card(_dest(d, n, p, dtype, kind, seed=len(case)), p, cuda)


# q95's groupings at SF10: the fact rows of round 1, the padded receive
# buffers of rounds 2-4, and the dimensions' and web_returns' shards
Q95_SHAPES = ((8, 899_696), (8, 2_699_088), (8, 9_132), (8, 31_250),
              (8, 6), (8, 89_903), (8, 54_000))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", Q95_SHAPES)
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_kernel_equals_plain_at_q95s_shapes(cuda, shape, dtype):
    """Two thirds of a padded receive buffer's rows are pads (-1), the
    rest spread over the 8 shards."""
    d, n = shape
    gen = torch.Generator(device=cuda).manual_seed(n)
    dest = torch.randint(0, 8, shape, device=cuda, generator=gen)
    pads = torch.rand(shape, device=cuda, generator=gen) < 2 / 3
    _same_on_card(torch.where(pads, -1, dest).to(dtype), 8, cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("p", [1, 3, 128, dp.MAX_PARTITIONS])
def test_kernel_equals_plain_over_many_partitions(cuda, p):
    _same_on_card(_dest(8, 899_696, p, torch.int32, "random", seed=p), p,
                  cuda)


@pytest.mark.cuda
def test_kernel_reads_a_view_it_is_handed(cuda):
    big = _dest(4, 2 * TILE + 9, 8, torch.int64, "random", seed=2).to(cuda)
    _same_on_card(big[:, 3:], 8, cuda)
    _same_on_card(big[1:3], 8, cuda)


@pytest.mark.cuda
def test_kernel_refuses_on_the_card(cuda):
    dest = torch.zeros((2, 4), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        dp.dest_partition(dest, dp.MAX_PARTITIONS + 1)
    with pytest.raises(TypeError):
        dp.dest_partition(dest.to(torch.int16), 4)


@pytest.mark.cuda
def test_one_launch_a_grouping(cuda):
    data = torch.arange(8 * 5000 * 2, dtype=torch.int32,
                        device=cuda).reshape(8, 5000, 2)
    dest = _dest(8, 5000, 8, torch.int32, "random", seed=5).to(cuda)
    before = dp.LAUNCHES
    grouped, counts = exchange.group_by_destination(data, dest, 8)
    exchange.group_by_destination(data, dest.to(torch.int64), 8)
    assert dp.LAUNCHES == before + 2
    want_grouped, want_counts = exchange.group_by_destination(
        data.cpu(), dest.cpu(), 8)
    assert torch.equal(grouped.cpu(), want_grouped)
    assert torch.equal(counts.cpu(), want_counts)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(grouping_inputs.CASES))
def test_group_by_destination_on_the_card_is_jaxs(cuda, case):
    """``group_by_destination`` on the card, through the kernel, against
    the JAX package's grouping of the same arrays, shard by shard: the
    card has no JAX, so ``grouping_inputs.grouping`` stands for it, and
    ``test_torch_exchange.py`` holds that to ``jx.group_by_destination``
    on these arrays."""
    data, dest, p = grouping_inputs.inputs(case)
    want_grouped, want_counts = grouping_inputs.grouping(data, dest, p)
    before = dp.LAUNCHES
    grouped, counts = exchange.group_by_destination(
        torch.from_numpy(data).to(cuda), torch.from_numpy(dest).to(cuda), p)
    torch.cuda.synchronize()
    assert dp.LAUNCHES == before + 1
    assert counts.dtype == torch.int32
    grouped, counts = grouped.cpu().numpy(), counts.cpu().numpy()
    for d in range(len(data)):
        np.testing.assert_array_equal(grouped[d], want_grouped[d])
        np.testing.assert_array_equal(counts[d], want_counts[d])


@pytest.mark.cuda
def test_group_span_opens_and_closes_on_its_own_kernels(cuda):
    """On the card a span's range runs from its first to its last own
    kernel: ``exchange.group`` starts before the row gather's
    ``mesh.take_rows`` range and ends after it, so its device time holds
    the gather."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    data = torch.zeros((8, 300_000, 8), dtype=torch.int32, device=cuda)
    dest = _dest(8, 300_000, 8, torch.int32, "random", seed=6).to(cuda)
    exchange.group_by_destination(data, dest, 8)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        exchange.group_by_destination(data, dest, 8)
        torch.cuda.synchronize()
    ranges = {}
    for evt in prof.events():
        if evt.device_type != DeviceType.CPU and evt.is_user_annotation:
            ranges.setdefault(evt.name, []).append(
                (evt.time_range.start, evt.time_range.end))
    (group,), (take,) = ranges["exchange.group"], ranges["mesh.take_rows"]
    assert group[0] < take[0] and take[1] < group[1]
