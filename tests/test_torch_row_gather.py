"""The row gather under ``parallel.mesh.take_rows``: its plain version
against a numpy take per shard, ``take_rows`` against the flat
``index_select`` it replaced and its byte counter, the host side of the
CUDA kernel (the vector width, the launches a large gather is cut into,
the ctypes signatures against ``csrc/row_gather.cu``) and the kernel's
index arithmetic emulated chunk by chunk; then, marked ``cuda``, the
kernel against its plain version on the card. This file imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_row_gather.py
"""

import ctypes
import math
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from sparkrdma_tpu_torch.ops import row_gather as rg
from sparkrdma_tpu_torch.parallel.mesh import take_rows
from sparkrdma_tpu_torch.utils import trace

ROW_DTYPES = (torch.int32, torch.int64, torch.float32, torch.bool)
WIDTHS = (1, 2, 3, 8, 25)
CASES = ("fewer", "empty", "repeated", "strided")


def _rows(d: int, n: int, w: int, dtype, seed: int) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    host = rng.integers(-2**31, 2**31, size=(d, n, w), dtype=np.int64)
    if dtype == torch.bool:
        return torch.from_numpy(host % 2 == 1)
    if dtype == torch.float32:
        return torch.from_numpy(host.astype(np.float32))
    return torch.from_numpy(host).to(dtype)


def _case(case: str, w: int, dtype, idx_dtype, seed: int = 0):
    """``(rows, idx)`` of one case: fewer indices than rows, none, more
    indices than rows (so some repeat), or rows that are a strided view."""
    d, n = 3, 11
    k = {"fewer": 7, "empty": 0, "repeated": 2 * n + 5, "strided": 9}[case]
    rows = _rows(d, n, w, dtype, seed)
    if case == "strided":
        rows = _rows(d, 2 * n, w, dtype, seed)[:, ::2]
        assert not rows.is_contiguous()
    rng = np.random.default_rng(seed + 1)
    idx = torch.from_numpy(rng.integers(0, n, size=(d, k))).to(idx_dtype)
    return rows, idx


def _numpy_take(rows: torch.Tensor, idx: torch.Tensor) -> np.ndarray:
    r, i = rows.numpy(), idx.numpy()
    return np.stack([np.take(r[d], i[d], axis=0) for d in range(r.shape[0])])


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("idx_dtype", (torch.int32, torch.int64))
@pytest.mark.parametrize("dtype", ROW_DTYPES)
@pytest.mark.parametrize("w", WIDTHS)
def test_plain_is_a_numpy_take_per_shard(w, dtype, idx_dtype, case):
    rows, idx = _case(case, w, dtype, idx_dtype, seed=w)
    want = _numpy_take(rows, idx)
    got = rg.row_gather_plain(rows, idx)
    assert got.dtype == rows.dtype and got.shape == want.shape
    assert np.array_equal(got.numpy(), want)
    before = rg.LAUNCHES
    assert torch.equal(rg.row_gather(rows, idx), got)   # the CPU: plain
    assert rg.LAUNCHES == before


@pytest.mark.parametrize("shape,dtype", [((8, 50, 8), torch.int32),
                                         ((4, 20), torch.int64),
                                         ((2, 10, 3, 2), torch.float32),
                                         ((3, 9, 25), torch.int32)])
def test_take_rows_is_the_flat_index_select_and_counts_its_bytes(shape,
                                                                 dtype):
    """``take_rows`` on the CPU equals the flat ``index_select`` it ran
    before the kernel, byte for byte, and counts the same bytes: picked
    rows x (2 x row bytes + 8)."""
    rows = torch.arange(math.prod(shape)).reshape(shape).to(dtype)
    idx = torch.randint(0, shape[1], (shape[0], 2 * shape[1]))
    d, n = shape[0], shape[1]
    flat = idx + torch.arange(d)[:, None] * n
    want = rows.reshape((d * n,) + shape[2:]).index_select(
        0, flat.reshape(-1)).reshape(idx.shape + shape[2:])
    assert not trace.counting()          # the next counted call starts at 0
    with profile(activities=[ProfilerActivity.CPU]):
        got = take_rows(rows, idx)
    assert got.view(torch.uint8).numpy().tobytes() == \
        want.view(torch.uint8).numpy().tobytes()
    row_bytes = math.prod(shape[2:]) * rows.element_size()
    assert trace.counts()["gather.bytes"] == idx.numel() * (2 * row_bytes
                                                            + 8)


@pytest.mark.parametrize("row_bytes,bases,want", [
    (32, (0, 256), 16),           # q95's fact rows
    (8, (0, 512), 8),             # its dimension rows
    (4, (0, 512), 4),             # its returns rows
    (100, (0, 512), 4),           # TeraSort's rows
    (32, (4, 256), 4),            # a view 4 bytes into its storage
    (32, (8, 256), 8),
    (48, (0, 0), 16),
    (12, (0, 0), 4),
    (6, (0, 0), 2),
    (3, (0, 0), 1),
    (16, (0, 2), 2),
    (16, (1, 0), 1),
])
def test_vector_bytes_divides_the_row_and_both_bases(row_bytes, bases, want):
    assert rg.vector_bytes(row_bytes, *bases) == want


@pytest.mark.parametrize("d,k,limit", [
    (8, 100, 10_000), (8, 100, 800), (8, 100, 250), (8, 100, 99),
    (3, 7, 5), (1, 40, 7), (5, 1, 1)])
def test_pieces_cover_every_output_row_once_under_the_limit(d, k, limit):
    seen = np.zeros((d, k), dtype=np.int64)
    for d0, nd, k0, nk in rg.pieces(d, k, limit):
        assert nd >= 1 and nk >= 1 and nd * nk <= limit
        assert nd == 1 or (k0, nk) == (0, k)
        seen[d0:d0 + nd, k0:k0 + nk] += 1
    assert (seen == 1).all()


# -- the kernel's arithmetic, emulated ----------------------------------------

def _fast_div(divisor: int):
    """``fast_div`` in the CUDA source."""
    if divisor == 1:
        return (1, 0, 0)
    l = (divisor - 1).bit_length()                 # ceil(log2 divisor)
    mul = ((1 << (31 + l)) + divisor - 1) // divisor
    assert mul < 2**32
    return (divisor, mul, l - 1)


def _div_of(n: int, f) -> int:
    """``div_of`` in the CUDA source: a 32-bit multiply-high, a shift."""
    divisor, mul, shift = f
    return n if divisor == 1 else ((n * mul) >> 32) >> shift


@pytest.mark.parametrize("divisor", [1, 2, 3, 7, 25, 32, 100, 899_696,
                                     2_699_088, 4_000_000, 2**30,
                                     2**30 + 1, 2**31 - 1])
def test_fast_division_is_exact_below_two_to_the_31(divisor):
    f = _fast_div(divisor)
    rng = np.random.default_rng(divisor)
    ns = [0, 1, divisor - 1, divisor, divisor + 1, 2**31 - 1, 2**31 - 2,
          (2**31 - 1) // divisor * divisor,
          *rng.integers(0, 2**31, size=2000).tolist()]
    for n in ns:
        if n >= 0:
            assert _div_of(n, f) == n // divisor, (n, divisor)


def _emulate(rows: torch.Tensor, idx: torch.Tensor, limit: int) -> bytes:
    """The wrapper's launches and the kernel's arithmetic over the bytes
    of contiguous ``rows`` and ``idx``: each warp's run of ``32 * G``
    output rows, each row's source base from its index, and each chunk's
    source from the base of the row ``div_of`` names, as the kernel
    computes them."""
    d, n, k = rows.shape[0], rows.shape[1], idx.shape[1]
    row_bytes = math.prod(rows.shape[2:]) * rows.element_size()
    src = rows.contiguous().view(torch.uint8).numpy().reshape(-1)
    ids = idx.contiguous().numpy().reshape(-1)
    out = np.full(d * k * row_bytes, 0xAA, dtype=np.uint8)
    v = rg.vector_bytes(row_bytes, 0, 0)
    unroll = _UNROLL[v]
    chunks_a_row = row_bytes // v
    groups = 1 if chunks_a_row >= unroll else unroll // chunks_a_row
    for d0, nd, k0, nk in rg.pieces(d, k, limit):
        rows_at, first = d0 * n * row_bytes, d0 * k + k0
        total = nd * nk
        per_row, per_shard = _fast_div(chunks_a_row), _fast_div(nk)
        run_rows = 32 * groups
        for run in range((total + run_rows - 1) // run_rows):
            base = []
            for r in range(run * run_rows, (run + 1) * run_rows):
                if r < total:
                    at = int(ids[first + r])
                    assert 0 <= at < n
                    base.append((_div_of(r, per_shard) * n + at) * row_bytes)
                else:
                    base.append(0)
            chunks = min(run_rows, total - run * run_rows) * chunks_a_row
            o = (first + run * run_rows) * row_bytes
            for c in range(chunks):
                row = _div_of(c, per_row)
                off = rows_at + base[row] + (c - row * chunks_a_row) * v
                out[o + c * v:o + (c + 1) * v] = src[off:off + v]
    return out.tobytes()


@pytest.mark.parametrize("w,dtype,limit", [
    (8, torch.int32, 2**31 - 1), (25, torch.int32, 2**31 - 1),
    (25, torch.int32, 2000), (2, torch.int32, 7), (3, torch.bool, 11),
    (1, torch.int64, 5), (3, torch.int32, 75), (1, torch.int32, 2**31 - 1),
    (2, torch.int32, 2**31 - 1), (3, torch.int32, 2**31 - 1),
    (4, torch.int32, 2**31 - 1), (1, torch.int32, 500),
    (3, torch.int32, 333)])
def test_emulated_kernel_equals_plain(w, dtype, limit):
    """Every chunk lands once from the right source bytes, in runs of
    32 * G rows (G > 1 for rows of fewer chunks than a lane loads at a
    time) and a partial last run, also where the wrapper cuts the gather
    into launches by shards or by indices."""
    d, n, k = 3, 50, 700
    rows = _rows(d, n, w, dtype, 60 + w)
    idx = torch.from_numpy(np.random.default_rng(w).integers(
        0, n, size=(d, k)))
    want = rg.row_gather_plain(rows, idx)
    assert _emulate(rows, idx, limit) == \
        want.contiguous().view(torch.uint8).numpy().tobytes()


# -- the host side against the CUDA source ------------------------------------

_CU = (Path(rg.__file__).resolve().parents[1] / "csrc"
       / "row_gather.cu").read_text()
# kUnroll of each vector width's Word<V>: the chunks a lane loads at a time
# and the most row groups a run takes
_UNROLL = {int(m.group(1)): int(m.group(2)) for m in re.finditer(
    r"struct Word<(\d+)> \{[^}]*?kUnroll = (\d+);", _CU)}
_EXPORTED = dict(
    (m.group(2), (m.group(1), m.group(3)))
    for m in re.finditer(r'extern "C" ([\w ]+?\**) ?(\w+)\(([^)]*)\)', _CU))
_C_TYPES = {
    "int": (ctypes.c_int,),
    "long long": (ctypes.c_longlong,),
    "void*": (ctypes.c_void_p,),
    "const void*": (ctypes.c_void_p,),
    "const char*": (ctypes.c_char_p,),
}


def _c_type(decl: str) -> str:
    """``"const void* rows"`` -> ``"const void*"``."""
    return re.sub(r"\s+\*", "*", re.sub(r"\s*\w+$", "", decl.strip()))


@pytest.mark.parametrize("name", sorted(_EXPORTED))
def test_signatures_match_the_source(name):
    """``SIGNATURES`` binds every exported function of ``row_gather.cu``
    with its parameters' count and C types (every pointer and the stream
    as ``c_void_p``) and its return type."""
    assert set(rg.SIGNATURES) == set(_EXPORTED)
    ret, params = _EXPORTED[name]
    decls = [p for p in params.split(",") if p.strip() and p.strip() != "void"]
    argtypes, restype = rg.SIGNATURES[name]
    assert len(argtypes) == len(decls), (name, decls)
    for decl, ctype in zip(decls, argtypes):
        assert ctype in _C_TYPES[_c_type(decl)], (name, decl, ctype)
    assert restype in _C_TYPES[ret.replace(" *", "*")], (name, ret)


def test_the_row_limit_matches_the_source():
    found = re.search(r"constexpr long long kMaxRows = (0x[0-9a-f]+)LL;",
                      _CU)
    assert found and int(found.group(1), 16) == rg.MAX_ROWS


@pytest.mark.parametrize("rows,idx,error", [
    (torch.zeros((2, 4, 3)), torch.zeros((2, 3), dtype=torch.int16),
     TypeError),
    (torch.zeros((2, 4, 3)), torch.zeros((2, 3)), TypeError),
    (torch.zeros((2, 4, 3)), torch.zeros((6,), dtype=torch.int64),
     ValueError),
    (torch.zeros((2, 4, 3)), torch.zeros((3, 3), dtype=torch.int64),
     ValueError),
    (torch.zeros((4,)), torch.zeros((4, 1), dtype=torch.int64), ValueError),
])
def test_refuses_what_the_kernel_does_not_take(rows, idx, error):
    with pytest.raises(error):
        rg.row_gather(rows, idx)


# -- on the card --------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _on_card(rows, idx, device):
    return rows.to(device), idx.to(device)


_pieces = rg.pieces


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("idx_dtype", (torch.int32, torch.int64))
@pytest.mark.parametrize("dtype", ROW_DTYPES)
@pytest.mark.parametrize("w", WIDTHS)
def test_kernel_equals_plain(cuda, w, dtype, idx_dtype, case):
    rows, idx = _on_card(*_case(case, w, dtype, idx_dtype, seed=w), cuda)
    before = rg.LAUNCHES
    got = rg.row_gather(rows, idx)
    torch.cuda.synchronize()
    assert torch.equal(got, rg.row_gather_plain(rows, idx))
    assert rg.LAUNCHES == before + (case != "empty")


@pytest.mark.cuda
@pytest.mark.parametrize("offset_words", [1, 2, 3])
def test_kernel_on_views_off_the_vector_boundary(cuda, offset_words):
    """Rows and output that start off a 16-byte boundary take a narrower
    V; the result is the same."""
    d, n, w = 4, 300, 8
    storage = torch.empty(offset_words + d * n * w, dtype=torch.int32,
                          device=cuda)
    rows = storage[offset_words:].view(d, n, w)
    rows.copy_(_rows(d, n, w, torch.int32, 3).to(cuda))
    assert rows.is_contiguous() and rows.data_ptr() % 16
    idx = torch.randint(0, n, (d, 777), device=cuda)
    before = dict(rg.SHAPES)
    got = rg.row_gather(rows, idx)
    torch.cuda.synchronize()
    assert torch.equal(got, rg.row_gather_plain(rows, idx))
    v = rg.vector_bytes(32, rows.data_ptr(), got.data_ptr())
    assert v < 16 and rg.SHAPES[(32, v)] == before.get((32, v), 0) + 1


@pytest.mark.cuda
@pytest.mark.parametrize("d,n,k,w,limit", [(8, 500, 700, 25, 2_000),
                                           (8, 500, 700, 8, 333),
                                           (3, 64, 4000, 3, 1_000)])
def test_kernel_in_launches_cut_under_a_limit(cuda, monkeypatch, d, n, k, w,
                                              limit):
    """The launches of a gather cut by shards, or by one shard's indices,
    fill every output row from its own shard."""
    monkeypatch.setattr(rg, "pieces", lambda d_, k_: _pieces(d_, k_, limit))
    rows = _rows(d, n, w, torch.int32, 9).to(cuda)
    idx = torch.randint(0, n, (d, k), device=cuda)
    before = rg.LAUNCHES
    got = rg.row_gather(rows, idx)
    torch.cuda.synchronize()
    assert torch.equal(got, rg.row_gather_plain(rows, idx))
    assert rg.LAUNCHES == before + len(_pieces(d, k, limit)) > before + 1


@pytest.mark.cuda
def test_kernel_traps_on_an_index_out_of_range(cuda):
    """An index outside ``[0, N)`` stops the kernel before it reads out of
    bounds: the process's next synchronise raises (in a child process,
    since the fault ends its CUDA context)."""
    code = ("import torch\n"
            "from sparkrdma_tpu_torch.ops.row_gather import row_gather\n"
            "rows = torch.zeros((2, 10, 8), dtype=torch.int32, "
            "device='cuda')\n"
            "idx = torch.full((2, 5), 10, dtype=torch.int64, device='cuda')\n"
            "row_gather(rows, idx)\n"
            "torch.cuda.synchronize()\n"
            "print('no fault')\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300,
                          cwd=Path(__file__).resolve().parents[1])
    assert proc.returncode != 0 and "no fault" not in proc.stdout, \
        proc.stdout + proc.stderr
