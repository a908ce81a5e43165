"""ALS's normal equations (``ops/normal_equations.py``): the plain version
against float64 sums and solves (the ``benchmarks/reference/als.py``
arithmetic) with weighted and unweighted regularisation; the cut of the
rows into pieces (``piece_plan``) at its edges; the kernel's arithmetic
emulated on the CPU (rows ordered by entity, a piece's lanes and their
butterfly, the pieces added in order) against float64; the host side of
the CUDA kernel (its ctypes signatures and constants against
``csrc/normal_equations.cu``, what it refuses) and the ``als.gram_split``
counter. Then, marked ``cuda``, the kernel on the card against its plain
version and float64 at ranks 4, 8 and 10, with a hot entity of 231k rows
and one of 2^20 + 1, a shard of one-row entities and an empty shard; its
pieces against ``piece_plan``; its launches; a rank past its bound; and
no ``index_add_`` nor ``[rows, k, k]`` tensor on its path. The emulation
is a copy of the kernel's arithmetic: change it with the kernel. This
file imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_normal_equations.py
"""

import ctypes
import re
from dataclasses import replace
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmarks.reference import als as reference
from sparkrdma_tpu_torch.models import als
from sparkrdma_tpu_torch.ops import normal_equations as ne
from sparkrdma_tpu_torch.utils import trace

_CU = (Path(__file__).resolve().parents[1] / "sparkrdma_tpu_torch" / "csrc"
       / "normal_equations.cu").read_text()
P = ne.PIECE_ROWS


def _constant(name: str) -> int:
    found = re.search(rf"constexpr (?:int|unsigned|long long) {name} = "
                      rf"(0x[0-9a-f]+|\d+)(?:u|LL)?;", _CU)
    assert found, name
    return int(found.group(1), 0)


def _inputs(counts, k: int, fixed_rows: int, seed: int, entities=None,
            device="cpu") -> tuple:
    """Rows of the given counts per entity, in a random order, as the
    kernel takes them: ``(local_key int64, other int32, rating float32,
    fixed float32 [fixed_rows, k], entities)``; ``other`` and ``rating``
    are strided views of one ``[N, 3]`` row buffer, as the received rows
    are. Stars 1-5, unit-norm factors as MLlib's initialisation."""
    rng = np.random.default_rng(seed)
    counts = np.asarray(counts, np.int64)
    entities = entities or len(counts)
    keys = np.repeat(np.arange(len(counts)), counts)
    keys = keys[rng.permutation(len(keys))]
    rows = np.zeros((len(keys), 3), np.int32)
    rows[:, 0] = keys
    rows[:, 1] = rng.integers(0, fixed_rows, size=len(keys))
    rows[:, 2] = rng.integers(1, 6, size=len(keys)).astype(
        np.float32).view(np.int32)
    f = rng.standard_normal((fixed_rows, k))
    f /= np.linalg.norm(f, axis=1, keepdims=True)
    rows = torch.from_numpy(rows).to(device)
    return (rows[:, 0].to(torch.int64), rows[:, 1],
            rows[:, 2].view(torch.float32),
            torch.from_numpy(f.astype(np.float32)).to(device), entities)


def _float64(local_key, other, rating, fixed, entities):
    """The sums in float64, 2^20 rows at a time: ``(ata, atr, counts)``."""
    k = fixed.shape[1]
    fixed64 = fixed.to(torch.float64)
    ata = torch.zeros((entities, k, k), dtype=torch.float64,
                      device=fixed.device)
    atr = torch.zeros((entities, k), dtype=torch.float64, device=fixed.device)
    for lo in range(0, local_key.shape[0], 1 << 20):
        key = local_key[lo:lo + (1 << 20)]
        f = fixed64[other[lo:lo + (1 << 20)].to(torch.int64)]
        r = rating[lo:lo + (1 << 20)].to(torch.float64)
        ata.index_add_(0, key, f[:, :, None] * f[:, None, :])
        atr.index_add_(0, key, f * r[:, None])
    return ata, atr, torch.bincount(local_key, minlength=entities)


def _worst(ata, atr, want) -> float:
    """The largest over entities of the sums' distance from float64,
    over the float64 sums' norm (ata and atr together)."""
    got = torch.cat([ata.reshape(ata.shape[0], -1), atr], 1).to(torch.float64)
    ref = torch.cat([want[0].reshape(want[0].shape[0], -1), want[1]], 1)
    dist = torch.linalg.vector_norm(got - ref, dim=1)
    norm = torch.linalg.vector_norm(ref, dim=1)
    return float(torch.where(norm > 0, dist / torch.where(norm > 0, norm, 1),
                             dist).max())


# -- the plain version ---------------------------------------------------------

@pytest.mark.parametrize("k", [1, 4, 6])
def test_plain_sums_are_float64_sums_in_float32(k):
    args = _inputs([300, 0, 1, 57, 2, 0, 900], k, 40, seed=k, entities=16)
    ata, atr, counts = ne.normal_equations(*args)
    want = _float64(*args)
    assert ata.dtype == atr.dtype == torch.float32
    assert counts.dtype == torch.int32 and torch.equal(counts.to(torch.int64),
                                                       want[2])
    assert _worst(ata, atr, want) < 1e-5
    assert not ata[7:].any() and not atr[7:].any()      # padded entities
    assert not ata[1].any() and not ata[5].any()        # entities with no row


def test_plain_takes_no_rows():
    args = _inputs([], 4, 10, seed=1, entities=16)
    ata, atr, counts = ne.normal_equations(*args)
    assert ata.shape == (16, 4, 4) and atr.shape == (16, 4)
    assert not ata.any() and not atr.any() and not counts.any()


def _shard(seed: int, key_col: int):
    """One shard's received rows of a few hundred users and items, items
    Zipf-skewed, and the other side's unit factors."""
    rng = np.random.default_rng(seed)
    n, users, items, k = 4000, 300, 120, 6
    rows = np.zeros((n, 3), np.int32)
    rows[:, 0] = np.minimum(rng.zipf(1.3, size=n) - 1, items - 1)
    rows[:, 1] = rng.integers(0, users, size=n)
    rows[:, 2] = rng.integers(1, 6, size=n).astype(np.float32).view(np.int32)
    f = rng.standard_normal((users if key_col == 0 else items, k))
    f /= np.linalg.norm(f, axis=1, keepdims=True)
    cfg = als.ALSConfig(num_users=users, num_items=items, rank=k, reg=0.1)
    return torch.from_numpy(rows), torch.from_numpy(f.astype(np.float32)), cfg


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("key_col", [0, 1])
def test_plain_solve_is_the_float64_reference(key_col, weighted):
    """``solve_item_factors`` on the CPU (the plain sums) against the
    benchmark's float64 half-step, weighted by ``n_e`` and not, each
    factor within 1e-4 of its norm."""
    rows, fixed, cfg = _shard(11 + key_col, key_col)
    keys = torch.unique(rows[:, key_col].to(torch.int64))
    got = als.solve_item_factors(rows, fixed, replace(cfg,
                                                      weighted_reg=weighted),
                                 keys, key_col)
    want = reference.half_step(
        rows, fixed, key_col=key_col,
        num_out=cfg.num_items if key_col == 0 else cfg.num_users,
        reg=cfg.reg, weighted=weighted)[keys]
    dist = torch.linalg.vector_norm(got.to(torch.float64) - want, dim=1)
    assert (dist <= 1e-4 * torch.linalg.vector_norm(want, dim=1)).all()


# -- the pieces ------------------------------------------------------------------

def _offsets(counts) -> torch.Tensor:
    return torch.tensor([0] + list(np.cumsum(counts)), dtype=torch.int64)


@pytest.mark.parametrize("counts,padded", [
    ([P], 0),                          # exactly one piece
    ([P + 1], 0),                      # one row past it
    ([3, 2**20 + 1, 5], 0),            # a hot entity: 513 pieces
    ([P, 7, P + 2], 0),                # entities starting on a boundary
    ([1] * 5000, 0),                   # every entity one row
    ([0, 4, 0, 0, 2 * P], 11),         # empty entities, then padded ones
    ([], 16),                          # nothing but padding
])
def test_piece_plan_covers_every_row_once(counts, padded):
    counts = list(counts) + [0] * padded
    offsets = _offsets(counts)
    entity, first, rows = ne.piece_plan(offsets)
    n = int(offsets[-1])
    assert len(entity) == sum(-(-c // P) for c in counts)
    assert len(entity) <= ne.max_pieces(n, len(counts))
    assert ((rows >= 1) & (rows <= P)).all()
    # the pieces tile the rows in order, each inside an entity with rows
    assert int(rows.sum()) == n
    if n:
        assert int(first[0]) == 0 and int((first + rows)[-1]) == n
        assert torch.equal(first[1:], (first + rows)[:-1])
    assert (first >= offsets[entity]).all()
    assert (first + rows <= offsets[entity + 1]).all()
    assert (torch.tensor(counts, dtype=torch.int64)[entity] > 0).all()
    # only an entity's last piece is short, and a piece starts j P in
    assert ((first - offsets[entity]) % P == 0).all()
    short = rows < P
    assert (first[short] + rows[short] == offsets[entity[short] + 1]).all()


def test_piece_plan_at_the_edges():
    entity, first, rows = ne.piece_plan(_offsets([P, P + 1, 2**20 + 1]))
    assert entity[:3].tolist() == [0, 1, 1]
    assert rows[:3].tolist() == [P, P, 1]
    assert first[:3].tolist() == [0, P, 2 * P]       # on a boundary
    hot = entity == 2
    assert int(hot.sum()) == 2**20 // P + 1 and rows[hot][-1] == 1
    assert int(first[hot][0]) == 2 * P + 1


# -- the kernel's arithmetic, emulated --------------------------------------------

def _butterfly(lanes: torch.Tensor) -> torch.Tensor:
    """``__shfl_xor_sync`` sums over ``lanes [32, E]``: lane 0's result."""
    for d in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[torch.arange(32) ^ d]
    return lanes[0]


def _emulate(local_key, other, rating, fixed, entities):
    """The kernel's count, scan, place, pieces and combine on the CPU in
    float32 (its place a stable one: any order of an entity's rows is
    one the card may take). Returns ``(ata, atr, counts, split)``."""
    k = fixed.shape[1]
    tri = torch.tril_indices(k, k)
    counts = torch.bincount(local_key, minlength=entities)
    offsets = torch.cat([torch.zeros(1, dtype=torch.int64),
                         torch.cumsum(counts, 0)])
    order = torch.argsort(local_key, stable=True)
    f = fixed[other.to(torch.int64)[order]]
    r = rating[order]
    terms = torch.cat([f[:, tri[0]] * f[:, tri[1]], f * r[:, None]], 1)
    partial = []
    entity, first, rows = ne.piece_plan(offsets)
    for lo, n in zip(first.tolist(), rows.tolist()):
        lanes = torch.zeros((32, terms.shape[1]), dtype=torch.float32)
        for step in range(0, n, 32):           # lane l takes rows l, l + 32, ...
            block = terms[lo + step:lo + min(step + 32, n)]
            lanes[:len(block)] += block
        partial.append(_butterfly(lanes))
    sums = torch.zeros((entities, terms.shape[1]), dtype=torch.float32)
    for e, p in zip(entity.tolist(), partial):
        sums[e] += p                           # in piece order
    ata = torch.zeros((entities, k, k), dtype=torch.float32)
    ata[:, tri[0], tri[1]] = sums[:, :tri.shape[1]]
    ata[:, tri[1], tri[0]] = sums[:, :tri.shape[1]]
    return (ata, sums[:, tri.shape[1]:], counts.to(torch.int32),
            int((counts > P).sum()))


@pytest.mark.parametrize("case,counts,entities", [
    ("hot", [3, 5000, 1, 0, 2 * P, 40], 16),
    ("one_row_entities", [1] * 300, 512),
    ("boundary", [P, P + 1, 7], 16),
])
def test_emulated_kernel_is_float64_sums(case, counts, entities):
    args = _inputs(counts, 4, 50, seed=len(case), entities=entities)
    ata, atr, got_counts, split = _emulate(*args)
    want = _float64(*args)
    assert torch.equal(got_counts.to(torch.int64), want[2])
    assert split == sum(c > P for c in counts)
    assert torch.equal(ata, ata.transpose(1, 2))
    assert _worst(ata, atr, want) < 1e-5
    plain = ne.normal_equations_plain(*args)
    assert _worst(*plain[:2], want) < 1e-5


# -- the kernel's host side ----------------------------------------------------

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
    assert found == ne.SIGNATURES


def test_constants_match_the_source():
    assert _constant("kPieceRows") == ne.PIECE_ROWS
    assert _constant("kMaxRank") == ne.MAX_RANK
    assert _constant("kMaxRows") == ne.MAX_ROWS
    assert _constant("kMaxEntities") == ne.MAX_ENTITIES
    assert ne.entries(10) == 65 and ne.entries(ne.MAX_RANK) == 152
    assert ne.max_pieces(0, 16) == 16 and ne.max_pieces(P + 1, 16) == 18


def _refusal(kind: str) -> tuple:
    local_key, other, rating, fixed, entities = _inputs([5, 6], 4, 10, 3,
                                                        entities=16)
    if kind == "rank_past_bound":
        fixed = torch.zeros((10, ne.MAX_RANK + 1))
        return (local_key, other, rating, fixed, entities), ValueError
    if kind == "int32_keys":
        local_key = local_key.to(torch.int32)
    elif kind == "other_shape":
        other = other[:3]
    elif kind == "rating_bits":
        rating = rating.view(torch.int32)
    elif kind == "float64_factors":
        fixed = fixed.to(torch.float64)
    elif kind == "no_entities":
        return (local_key, other, rating, fixed, 0), ValueError
    return (local_key, other, rating, fixed, entities), TypeError


@pytest.mark.parametrize("kind", ["rank_past_bound", "int32_keys",
                                  "other_shape", "rating_bits",
                                  "float64_factors", "no_entities"])
def test_refuses_what_the_kernel_does_not_take(kind):
    args, error = _refusal(kind)
    with pytest.raises(error):
        ne._check(*args)


def test_counts_split_entities_while_profiled():
    """``als.gram_split`` counts the entities of more than one piece, only
    while a profiler records."""
    args = _inputs([P, P + 1, 3, 3 * P], 4, 30, seed=2, entities=16)
    assert not trace.counting()
    with profile(activities=[ProfilerActivity.CPU]):
        ne.normal_equations(*args)
        ne.normal_equations(*args)
    assert trace.counts() == {"als.gram_split": 4}


# -- on the card ---------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the CUDA kernel has no CPU mode")
    return torch.device("cuda")


CARD_CASES = {
    # a hot item of the cell's size among Zipf-ish others, and 2^20 + 1
    "hot": ([231_000, 2**20 + 1] + [1 + (7919 * i) % 3000
                                     for i in range(1500)], 2048, 480_189),
    # the user side: ~48k entities of ~200 rows, a padded tail
    "users": ([82 + (104_729 * i) % 400 for i in range(48_000)], 65_536,
              17_770),
    "one_row_entities": ([1] * 40_000, 65_536, 17_770),
    "empty": ([], 16, 1000),
}


@pytest.mark.cuda
@pytest.mark.parametrize("k", [4, 8, 10])
@pytest.mark.parametrize("case", sorted(CARD_CASES))
def test_kernel_against_plain_and_float64(cuda, case, k):
    """Counts exact; both triangles equal; the kernel's worst relative
    error against float64 no larger than the plain version's on the same
    rows; one launch a call with rows, none without."""
    counts, entities, fixed_rows = CARD_CASES[case]
    args = _inputs(counts, k, fixed_rows, seed=k, entities=entities,
                   device=cuda)
    before = ne.LAUNCHES
    ata, atr, got_counts = ne.normal_equations(*args)
    torch.cuda.synchronize()
    assert ne.LAUNCHES == before + (1 if counts else 0)
    want = _float64(*args)
    assert torch.equal(got_counts.to(torch.int64), want[2])
    assert torch.equal(ata, ata.transpose(1, 2))
    plain = ne.normal_equations_plain(*args)
    assert torch.equal(plain[2], got_counts)
    kernel_err, plain_err = _worst(ata, atr, want), _worst(*plain[:2], want)
    assert kernel_err <= plain_err
    assert kernel_err < 1e-5


@pytest.mark.cuda
def test_kernel_pieces_are_the_plan(cuda):
    """The kernel's offsets, pieces and split count are ``piece_plan``'s
    of its counts."""
    counts, entities, fixed_rows = CARD_CASES["hot"]
    args = _inputs(counts, 10, fixed_rows, seed=5, entities=entities,
                   device=cuda)
    out = ne._launch(*args)
    torch.cuda.synchronize()
    want_offsets = torch.cat([torch.zeros(1, dtype=torch.int64, device=cuda),
                              torch.cumsum(out["counts"].to(torch.int64), 0)])
    assert torch.equal(out["offsets"].to(torch.int64), want_offsets)
    entity, _, _ = ne.piece_plan(want_offsets)
    pieces = entity.numel()
    assert int(out["piece_start"][-1]) == pieces
    assert torch.equal(out["plan"][:pieces].to(torch.int64), entity)
    assert int(out["state"][0]) == sum(c > P for c in counts) > 2


@pytest.mark.cuda
def test_kernel_refuses_a_rank_past_its_bound(cuda):
    args = _inputs([3, 4], ne.MAX_RANK + 1, 10, seed=1, entities=16,
                   device=cuda)
    with pytest.raises(ValueError):
        ne.normal_equations(*args)


@pytest.mark.cuda
def test_the_solve_on_the_card_writes_no_outer_products(cuda, monkeypatch):
    """``solve_item_factors`` on the card: no ``index_add_``, no tensor of
    ``rows x k x k`` floats, one launch; the factors within the cell's
    limit of the float64 reference; ``als.gram_split`` counted on the card
    while profiled."""
    def refuse(*args, **kwargs):
        raise AssertionError("index_add_ on the Gram's path")

    counts = [231_000] + [1 + (7919 * i) % 2000 for i in range(1700)]
    local_key, other, rating, fixed, _ = _inputs(counts, 10, 480_189,
                                                 seed=9, device=cuda)
    rows = torch.stack([local_key.to(torch.int32), other,
                        rating.view(torch.int32)], 1)
    keys = torch.arange(len(counts), device=cuda)
    cfg = als.ALSConfig(num_users=480_189, num_items=len(counts), rank=10,
                        reg=0.1, weighted_reg=True)
    monkeypatch.setattr(torch.Tensor, "index_add_", refuse)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    before = ne.LAUNCHES
    assert not trace.counting()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        got = als.solve_item_factors(rows, fixed, cfg, keys, key_col=0)
    torch.cuda.synchronize()
    monkeypatch.undo()
    assert ne.LAUNCHES == before + 1
    assert torch.cuda.max_memory_allocated() - base < rows.shape[0] * 4 * 10 * 10
    assert trace.counts()["als.gram_split"] == 1
    want = reference.half_step(rows, fixed, key_col=0, num_out=len(counts),
                               reg=cfg.reg)
    dist = torch.linalg.vector_norm(got.to(torch.float64) - want, dim=1)
    assert (dist <= 2e-4 * torch.linalg.vector_norm(want, dim=1)).all()
