"""The unique-key lookup of the query plans' joins
(``ops/hash_lookup.py``): its plain version against ``lookup_unique``
called on the keys the callers formed before and against a numpy dict
lookup, on pair words past 2**16 and 2**24, one-word keys of 0xFFFFFFFF,
dead rows, duplicate keys, all-pad shards and misses; the host side of
the CUDA kernel (the ctypes signatures and constants against
``csrc/hash_lookup.cu``); and the kernel's build and probe emulated row by
row, in several insertion orders, with its overflow flag. Then, marked
``cuda``, the kernel against its plain version on the card (``found``
exact, ``attr`` exact where found and 0 elsewhere) at the same cases, at
q64's store-join shape and at q95's, past its bound, and with no sort
on its path. The emulation is a copy of the kernel's arithmetic: change it
with the kernel. This file imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_hash_lookup.py
"""

import ctypes
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from sparkrdma_tpu_torch.ops import hash_lookup as hl
from sparkrdma_tpu_torch.ops.sort import lookup_unique
from sparkrdma_tpu_torch.utils import trace
from sparkrdma_tpu_torch.utils.u32 import SENTINEL, SENTINEL64, to_u64

_CU = (Path(__file__).resolve().parents[1] / "sparkrdma_tpu_torch" / "csrc"
       / "hash_lookup.cu").read_text()


def _constant(name: str) -> int:
    found = re.search(rf"constexpr (?:int|unsigned|long long) {name} = "
                      rf"(0x[0-9a-f]+|\d+)(?:u|LL)?;", _CU)
    assert found, name
    return int(found.group(1), 0)


MAX_PROBE = _constant("kMaxProbe")
EMPTY = _constant("kEmpty")
M64 = (1 << 64) - 1

# name -> (words, shards, dimension rows, probe rows, kind)
CASES = {
    "pairs_wide": (2, 3, 700, 900, "wide"),
    "pairs_dead_items": (2, 2, 500, 600, "dead"),
    "pairs_duplicates": (2, 3, 400, 500, "duplicates"),
    "one_word": (1, 3, 600, 800, "wide"),
    "one_word_ffffffff": (1, 2, 300, 400, "ffffffff"),
    "one_word_duplicates": (1, 2, 500, 500, "duplicates"),
    "all_pad_shards": (2, 4, 300, 300, "all_pad"),
    "misses": (1, 3, 200, 300, "misses"),
    "one_shard": (2, 1, 257, 2049, "wide"),
    "no_dimension_rows": (1, 3, 0, 100, "wide"),
    "no_probes": (2, 3, 100, 0, "wide"),
}


def _case(name: str, seed: int = 0) -> dict:
    """One case's tensors: ``dim_keys``/``probe_keys`` (tuples of int32
    ``[D, N]`` strided views of row buffers, most significant word
    first), ``dim_valid``/``probe_valid`` (bool) and ``dim_attr``;
    integer arithmetic alone, so both machines build the same arrays."""
    words, d, m, p, kind = CASES[name]
    rng = np.random.default_rng(seed + len(name))
    if words == 2:
        items = np.array([0, 1, 65535, 65536, 65537, 70_000, 102_000,
                          2**31 - 2], np.uint64)
        hi = rng.choice(items, size=(d, m))
        lo = rng.integers(0, 2**32, size=(d, m), dtype=np.uint64)
        lo[:, ::7] = rng.choice([0, 2**24, 2**24 + 1, 2**32 - 1],
                                size=lo[:, ::7].shape)
    else:
        hi = None
        lo = rng.integers(0, 2**32 - 1, size=(d, m), dtype=np.uint64)
    if kind == "duplicates":
        lo = lo % 37
        if hi is not None:
            hi = hi % 2
    if kind == "ffffffff":
        lo[:, ::5] = 0xFFFFFFFF
    if kind == "misses":
        lo &= ~np.uint64(1)                  # even keys; the probes odd
    if kind == "dead" and m:
        hi[:, ::3] = 0xFFFFFFFF
        hi[:, 1::11] = 0x7FFFFFFF          # the first word past the limit
    dim_valid = rng.random((d, m)) < 0.8
    if kind == "all_pad":
        dim_valid[1] = False
    # probes: live dimension keys of the same shard, of another shard,
    # and keys drawn anew
    src = rng.integers(0, max(m, 1), size=(d, p))
    other = (np.arange(d)[:, None] + 1) % d
    pick = rng.random((d, p))
    if m:
        plo = np.where(pick < 0.5, np.take_along_axis(lo, src, 1),
                       np.where(pick < 0.7, lo[other, src],
                                rng.integers(0, 2**32, size=(d, p),
                                             dtype=np.uint64)))
        phi = (None if hi is None else
               np.where(pick < 0.5, np.take_along_axis(hi, src, 1),
                        np.where(pick < 0.7, hi[other, src],
                                 rng.choice(items, size=(d, p)))))
    else:
        plo = rng.integers(0, 2**32, size=(d, p), dtype=np.uint64)
        phi = None if hi is None else rng.choice(items, size=(d, p))
    if kind == "misses":
        plo = plo | 1
    if kind == "ffffffff":
        plo[:, ::4] = 0xFFFFFFFF
    probe_valid = rng.random((d, p)) < 0.7
    if kind == "all_pad":
        probe_valid[2] = False
    attr = rng.integers(0, 2**32, size=(d, m), dtype=np.uint64)

    def rows(*cols):
        """The columns as int32 words of one row buffer [D, N, W + 1] (a
        trailing word, so every view is strided)."""
        n = cols[0].shape[1]
        buf = np.zeros((d, n, len(cols) + 1), np.uint32)
        for i, c in enumerate(cols):
            buf[..., i] = c.astype(np.uint32)
        return torch.from_numpy(buf.view(np.int32))

    dim = rows(*([hi] if words == 2 else []), lo, attr)
    probe = rows(*([phi] if words == 2 else []), plo)
    return {"dim_keys": tuple(dim[..., i] for i in range(words)),
            "dim_valid": torch.from_numpy(dim_valid),
            "dim_attr": dim[..., words],
            "probe_keys": tuple(probe[..., i] for i in range(words)),
            "probe_valid": torch.from_numpy(probe_valid)}


def _args(c: dict, device=None, attr=True, valid=True) -> tuple:
    def on(t):
        return None if t is None else (t if device is None else t.to(device))
    keys = (lambda ks: tuple(on(k) for k in ks))
    return (keys(c["dim_keys"]), on(c["dim_valid"]) if valid else None,
            on(c["dim_attr"]) if attr else None, keys(c["probe_keys"]),
            on(c["probe_valid"]) if valid else None)


def _key(words: tuple, s: int, r: int):
    """Row r of shard s's key as a Python int, or None where it is no key
    (the kernel's rule)."""
    vals = [int(w[s, r]) & 0xFFFFFFFF for w in words]
    if len(vals) == 2:
        return None if vals[0] >= hl.HIGH_LIMIT else (vals[0] << 32) | vals[1]
    return None if vals[0] == hl.NO_KEY else vals[0]


def _live(valid, s: int, r: int) -> bool:
    return valid is None or bool(valid[s, r])


def _taking(keys: tuple, valid) -> int:
    """How many rows of one side take part: valid, and a key (the
    kernel's rule), on the keys' own device."""
    first = keys[0].to(torch.int64) & 0xFFFFFFFF
    key = first < hl.HIGH_LIMIT if len(keys) == 2 else first != hl.NO_KEY
    return int((key if valid is None else key & valid).sum())


def _dict_lookup(dim_keys, dim_valid, dim_attr, probe_keys, probe_valid):
    """``(attr int64, found bool)`` by a dict a shard: each live key's
    lowest row; attr 0 where not found."""
    d, p = probe_keys[0].shape
    m = dim_keys[0].shape[1]
    attr = np.zeros((d, p), np.int64)
    found = np.zeros((d, p), bool)
    for s in range(d):
        table = {}
        for r in range(m):
            k = _key(dim_keys, s, r) if _live(dim_valid, s, r) else None
            if k is not None:
                table.setdefault(k, int(dim_attr[s, r]) & 0xFFFFFFFF)
        for r in range(p):
            k = _key(probe_keys, s, r) if _live(probe_valid, s, r) else None
            if k in table:
                found[s, r] = True
                attr[s, r] = table[k]
    return attr, found


def _as_before(dim_keys, dim_valid, dim_attr, probe_keys, probe_valid):
    """``lookup_unique`` called as the plans called it before the hash
    lookup: q64's int64 pairs ``item << 32 | key`` with ``SENTINEL64`` for
    a dead item word, q95's int32 words against zero-extended probes with
    ``SENTINEL`` for the rows not valid."""
    if len(dim_keys) == 2:
        def pair(hi, lo):
            item = to_u64(hi)
            return torch.where(item < (1 << 31) - 1,
                               (item << 32) | to_u64(lo), SENTINEL64)
        return lookup_unique(pair(*dim_keys), dim_valid, dim_attr,
                             torch.where(probe_valid, pair(*probe_keys),
                                         SENTINEL64))
    return lookup_unique(dim_keys[0], dim_valid, dim_attr,
                         torch.where(probe_valid, to_u64(probe_keys[0]),
                                     SENTINEL))


def _check_answer(attr, found, want_attr, want_found, zero_elsewhere):
    found = found.cpu().numpy()
    np.testing.assert_array_equal(found, want_found)
    if attr is None:
        return
    attr = attr.cpu().numpy()
    np.testing.assert_array_equal(attr[found], want_attr[found])
    if zero_elsewhere:
        assert not attr[~found].any()


# -- the plain version ---------------------------------------------------------

@pytest.mark.parametrize("case", sorted(set(CASES) - {"no_dimension_rows"}))
def test_plain_is_lookup_unique_on_the_keys_of_before(case):
    c = _case(case)
    attr, found, overflowed = hl.hash_lookup(*_args(c), bound=10**9)
    want_attr, want_found = _as_before(*_args(c))
    assert attr.dtype == torch.int64 and found.dtype == torch.bool
    assert torch.equal(attr, want_attr) and torch.equal(found, want_found)
    assert overflowed.shape == (found.shape[0],) and not overflowed.any()


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_a_numpy_dict_lookup(case):
    c = _case(case)
    attr, found, _ = hl.hash_lookup(*_args(c), bound=10**9)
    _check_answer(attr, found, *_dict_lookup(*_args(c)),
                  zero_elsewhere=False)
    if found.numel():
        assert 0 < found.sum() < found.numel() or case in (
            "misses", "no_dimension_rows")


def test_the_cases_reach_what_they_name():
    """Pairs past 2**16 items and 2**24 tickets are found, 0xFFFFFFFF is
    never found though valid, duplicates answer with their lowest row,
    and an all-pad shard finds nothing."""
    c = _case("pairs_wide")
    _, found, _ = hl.hash_lookup(*_args(c), bound=10**9)
    hi, lo = (k.numpy().view(np.uint32) for k in c["probe_keys"])
    assert (found.numpy() & (hi >= 65536) & (lo >= 2**24)).any()
    c = _case("one_word_ffffffff")
    _, found, _ = hl.hash_lookup(*_args(c), bound=10**9)
    ffff = c["probe_keys"][0].numpy() == -1
    assert (ffff & c["probe_valid"].numpy()).any()
    assert not found.numpy()[ffff].any()
    c = _case("one_word_duplicates")
    dk, attr = c["dim_keys"][0].numpy(), c["dim_attr"].numpy()
    live = c["dim_valid"].numpy()
    k = dk[0][live[0]][0]
    rows = np.flatnonzero(live[0] & (dk[0] == k))
    assert len(rows) > 1 and len(set(attr[0][rows].tolist())) > 1
    probe = (torch.full((2, 1), int(k), dtype=torch.int32),)
    got, found, _ = hl.hash_lookup(c["dim_keys"], c["dim_valid"],
                                   c["dim_attr"], probe, None, 10**9)
    assert found[0, 0] and got[0, 0] == int(attr[0][rows[0]]) & 0xFFFFFFFF
    c = _case("all_pad_shards")
    _, found, _ = hl.hash_lookup(*_args(c), bound=10**9)
    assert not found[1].any() and not found[2].any() and found[0].any()


@pytest.mark.parametrize("words", [1, 2])
def test_plain_flags_past_its_bound(words):
    c = _case("one_word" if words == 1 else "pairs_wide")
    taking = _taking(c["dim_keys"], c["dim_valid"])
    _, _, ok = hl.hash_lookup(*_args(c), bound=taking)
    _, _, over = hl.hash_lookup(*_args(c), bound=taking - 1)
    assert not ok.any() and over.all()


def test_without_masks_or_attribute():
    """No valid masks: every row takes part where its key is a key; no
    attribute: no ``attr``."""
    c = _case("one_word_ffffffff")
    attr, found, _ = hl.hash_lookup(*_args(c, attr=False, valid=False),
                                    bound=10**9)
    assert attr is None
    _check_answer(None, found, *_dict_lookup(*_args(c, valid=False)),
                  zero_elsewhere=False)


def test_low_word_and_pair64():
    values = torch.tensor([[0, 1, 0xFFFFFFFF, 0x12345678]], dtype=torch.int64)
    low = hl.low_word(values)
    assert low.dtype == torch.int32 and low.stride() == (8, 2)
    assert to_u64(low).tolist() == values.tolist()
    words = torch.tensor([[0, 0], [1, -1], [0x7FFFFFFE, -1], [0x7FFFFFFF, 5],
                          [-1, -1]], dtype=torch.int32)
    assert hl.pair64(words[:, 0], words[:, 1]).tolist() == [
        0, (1 << 32) | 0xFFFFFFFF, (0x7FFFFFFE << 32) | 0xFFFFFFFF,
        SENTINEL64, SENTINEL64]
    with pytest.raises(ValueError):
        hl.low_word(values.to(torch.int32))


def test_table_slots():
    for bound in (0, 1, 42, 128, 129, 2_875_432, 10**9):
        slots = hl.table_slots(bound)
        assert slots & (slots - 1) == 0 and slots >= 2 * bound
        assert slots >= hl.MIN_SLOTS and (slots < 4 * bound
                                          or slots == hl.MIN_SLOTS)
    assert hl.table_slots(2_875_432) == 8 * 2**20


# -- the kernel's host side ------------------------------------------------------

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
    assert found == hl.SIGNATURES


def test_constants_match_the_source():
    assert _constant("kHighLimit") == hl.HIGH_LIMIT
    assert _constant("kNoKey") == hl.NO_KEY
    assert _constant("kMaxRows") == hl.MAX_ROWS
    assert EMPTY == 0xFFFFFFFF > hl.MAX_ROWS


def _refusal(kind: str) -> tuple:
    c = _case("pairs_wide")
    dk, dv, da, pk, pv = _args(c)
    if kind == "three_words":
        dk = dk + dk[:1]
    elif kind == "int64_words":
        dk = (dk[0].to(torch.int64), dk[1])
    elif kind == "words_differ":
        pk = pk[:1]
    elif kind == "shards_differ":
        pk = tuple(k[:2] for k in pk)
        pv = pv[:2]
    elif kind == "valid_not_bool":
        dv = dv.to(torch.int32)
    elif kind == "attr_shape":
        da = da[:, :5]
    elif kind == "negative_bound":
        return (dk, dv, da, pk, pv, -1), ValueError
    return (dk, dv, da, pk, pv, 10), (
        TypeError if kind in ("int64_words", "attr_shape") else ValueError)


@pytest.mark.parametrize("kind", ["three_words", "int64_words",
                                  "words_differ", "shards_differ",
                                  "valid_not_bool", "attr_shape",
                                  "negative_bound"])
def test_refuses_what_the_kernel_does_not_take(kind):
    args, error = _refusal(kind)
    with pytest.raises(error):
        hl._check(*args)


# -- the kernel's two passes, emulated ----------------------------------------

def _home(key: int, s: int, mask: int) -> int:
    h = key ^ (((s + 1) * 0x9E3779B97F4A7C15) & M64)
    h ^= h >> 33
    h = (h * 0xFF51AFD7ED558CCD) & M64
    h ^= h >> 33
    h = (h * 0xC4CEB9FE1A85EC53) & M64
    h ^= h >> 33
    return h & mask


def _emulate(dim_keys, dim_valid, dim_attr, probe_keys, probe_valid,
             bound: int, order_seed: int, slots: int = 0):
    """The kernel's clear, build and probe, one live row at a time in a
    drawn order (threads race in no set order): ``(attr, found,
    flagged)``."""
    d, p = probe_keys[0].shape
    m = dim_keys[0].shape[1]
    slots = slots or hl.table_slots(bound)
    mask, max_probe = slots - 1, min(slots, MAX_PROBE)
    row_of = [EMPTY] * slots
    key_of = [M64] * slots
    live = [(s, r, _key(dim_keys, s, r)) for s in range(d) for r in range(m)
            if _live(dim_valid, s, r) and _key(dim_keys, s, r) is not None]
    flagged = len(live) > bound
    order = np.random.default_rng(order_seed).permutation(len(live))
    for i in order:
        if flagged:
            break
        s, r, key = live[i]
        row, base = s * m + r, s * m
        pos = _home(key, s, mask)
        for _ in range(max_probe):
            held = row_of[pos]
            if held == EMPTY:
                row_of[pos], key_of[pos] = row, key
                break
            if ((held - base) & 0xFFFFFFFF) < m and _key(
                    dim_keys, s, held - base) == key:
                row_of[pos] = min(held, row)
                break
            pos = (pos + 1) & mask
        else:
            flagged = True
    attr = np.zeros((d, p), np.int64)
    found = np.zeros((d, p), bool)
    for s in range(d):
        base = s * m
        for r in range(p):
            key = _key(probe_keys, s, r) if _live(probe_valid, s, r) else None
            if flagged or key is None:
                continue
            pos = _home(key, s, mask)
            for _ in range(max_probe):
                held = row_of[pos]
                if held == EMPTY:
                    break
                if key_of[pos] == key and ((held - base) & 0xFFFFFFFF) < m:
                    found[s, r] = True
                    attr[s, r] = int(dim_attr[s, held - base]) & 0xFFFFFFFF
                    break
                pos = (pos + 1) & mask
    return attr, found, flagged


@pytest.mark.parametrize("order_seed", [0, 1])
@pytest.mark.parametrize("case", ["pairs_wide", "pairs_dead_items",
                                  "pairs_duplicates", "one_word_ffffffff",
                                  "one_word_duplicates", "all_pad_shards",
                                  "misses", "no_dimension_rows"])
def test_emulated_kernel_matches_a_numpy_dict_lookup(case, order_seed):
    c = _case(case)
    args = _args(c)
    attr, found, flagged = _emulate(*args, bound=10**6, order_seed=order_seed)
    assert not flagged
    _check_answer(torch.from_numpy(attr), torch.from_numpy(found),
                  *_dict_lookup(*args), zero_elsewhere=True)


def test_emulated_kernel_shares_a_table_across_shards_at_its_bound():
    """At its bound the table is half full; keys equal across shards take
    slots of their own and answer only their shard's probes."""
    d, m = 4, 64
    words = torch.arange(m, dtype=torch.int32).repeat(d, 1)
    attr = (words * 10 + torch.arange(d, dtype=torch.int32)[:, None])
    probes = (words.flip(1),)
    got, found, flagged = _emulate((words,), None, attr, probes, None,
                                   bound=d * m, order_seed=3)
    assert not flagged and found.all()
    assert (got == (probes[0] * 10 + torch.arange(d)[:, None]).numpy()).all()


def test_emulated_kernel_flags_past_its_bound_or_a_full_table():
    c = _case("pairs_wide")
    args = _args(c)
    taking = _taking(c["dim_keys"], c["dim_valid"])
    *_, flagged = _emulate(*args, bound=taking, order_seed=0)
    assert not flagged
    attr, found, flagged = _emulate(*args, bound=taking - 1, order_seed=0)
    assert flagged and not found.any() and not attr.any()
    # a table smaller than the rows: the walk ends, flagged
    *_, flagged = _emulate(*args, bound=taking, order_seed=0, slots=256)
    assert flagged


# -- on the card ----------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _same_on_card(args: tuple, bound: int):
    """The kernel against its plain version on the card: found exact,
    attr exact where found and 0 elsewhere, one launch, no flag."""
    before = hl.LAUNCHES
    attr, found, overflowed = hl.hash_lookup(*args, bound=bound)
    torch.cuda.synchronize()
    assert hl.LAUNCHES == before + 1
    assert not overflowed.any()
    want_attr, want_found = hl.hash_lookup_plain(*args)
    assert found.dtype == torch.bool and torch.equal(found, want_found)
    if want_attr is None:
        assert attr is None
        return found
    assert attr.dtype == torch.int64
    assert torch.equal(attr[found], want_attr[found])
    assert not attr[~found].any()
    return found


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_equals_plain_at_the_edges(cuda, case):
    c = _case(case)
    _same_on_card(_args(c, cuda), bound=10**6)
    _same_on_card(_args(c, cuda, attr=False, valid=False), bound=10**6)


def _received(d: int, n: int, live: int, cols: int, gen) -> torch.Tensor:
    """A receive buffer ``[d, n, cols]`` of int32 words whose first
    ``live`` rows a shard are drawn and the rest zero, and its valid
    mask (the live prefix)."""
    rows = torch.zeros((d, n, cols), dtype=torch.int32, device="cuda")
    rows[:, :live] = torch.randint(-2**31, 2**31 - 1, (d, live, cols),
                                   dtype=torch.int32, device="cuda",
                                   generator=gen)
    valid = (torch.arange(n, device="cuda") < live).expand(d, n).contiguous()
    return rows, valid


@pytest.mark.cuda
def test_kernel_equals_plain_at_q64s_store_join(cuda):
    """[8, 14,400,496] slots a side (q64's ``out_factor`` 4 over 3,600,124
    store lines a shard), 359,429 live returns a shard, every one a sale's
    pair, and 3,600,124 live sales: the store join's shape at SF10."""
    d, n, live_dim, live_probe = 8, 14_400_496, 359_429, 3_600_124
    gen = torch.Generator(device=cuda).manual_seed(64)
    ss, ss_v = _received(d, n, live_probe, 4, gen)
    ss[..., 0] = torch.randint(0, 102_000, (d, n), dtype=torch.int32,
                               device=cuda, generator=gen)
    ss[:, live_probe:, 0] = -1                      # dead rows' PAD item
    sr, sr_v = _received(d, n, live_dim, 2, gen)
    pick = torch.stack([torch.randperm(live_probe, device=cuda,
                                       generator=gen)[:live_dim]
                        for _ in range(d)])
    sr[:, :live_dim] = ss[:, :, :2].gather(1, pick[..., None].expand(-1, -1,
                                                                      2))
    found = _same_on_card(((sr[..., 0], sr[..., 1]), sr_v, None,
                           (ss[..., 0], ss[..., 1]), ss_v), d * 359_430)
    assert found[:, :live_probe].sum() >= d * live_dim * 0.99
    attr_args = ((sr[..., 0], sr[..., 1]), sr_v, sr[..., 1],
                 (ss[..., 0], ss[..., 1]), ss_v)
    _same_on_card(attr_args, d * 359_430)


@pytest.mark.parametrize("dim_rows,live_dim,probe_rows,live_probe", [
    (73_056, 9_132, 2_699_088, 899_696),     # q95 SF10's date round
    (336, 42, 2_699_088, 899_696),           # its web_site round
    (432_000, 54_000, 2_699_088, 899_696),   # its returns semi-join
])
@pytest.mark.cuda
def test_kernel_equals_plain_at_q95s_shapes(cuda, dim_rows, live_dim,
                                            probe_rows, live_probe):
    d = 8
    gen = torch.Generator(device=cuda).manual_seed(dim_rows)
    dim, dim_v = _received(d, dim_rows, live_dim, 2, gen)
    dim[..., 0] = torch.randperm(dim_rows * d, device=cuda,
                                 generator=gen)[:dim_rows].to(torch.int32)
    probe, probe_v = _received(d, probe_rows, live_probe, 8, gen)
    probe[..., 2] = torch.randint(0, dim_rows * 2, (d, probe_rows),
                                  dtype=torch.int32, device=cuda,
                                  generator=gen)
    _same_on_card(((dim[..., 0],), dim_v, dim[..., 1], (probe[..., 2],),
                   probe_v), d * dim_rows // 8)


@pytest.mark.cuda
@pytest.mark.parametrize("words", [1, 2])
def test_kernel_keeps_the_lowest_row_of_racing_duplicates(cuda, words):
    """A million valid rows a shard drawn from a million keys: about 37% of
    the rows repeat a key another thread inserts at the same time, and the
    table is about 30% full (the store join's load), so equal keys race
    for one slot while unequal ones collide on long paths. Every key must
    sit in one slot answering with its lowest row (``attr`` is the row
    number), as the stable sort does; a build that compared a held slot's
    key before its owner stored it would leave a second copy, found first
    for some probes, and answer with a higher row."""
    d, m, p = 8, 1 << 20, 1 << 20
    gen = torch.Generator(device=cuda).manual_seed(100 + words)
    dim = torch.zeros((d, m, 3), dtype=torch.int32, device=cuda)
    dim[..., 1] = torch.randint(0, m, (d, m), dtype=torch.int32,
                                device=cuda, generator=gen)
    if words == 2:       # the pair (hi, lo) of a key below m
        dim[..., 0] = dim[..., 1] >> 10
        dim[..., 1] &= 1023
    dim[..., 2] = torch.arange(m, dtype=torch.int32, device=cuda)
    probe = dim[:, torch.randperm(m, device=cuda, generator=gen)[:p]].clone()
    probe[:, ::4, 1] += m               # a miss in four
    keys = tuple(dim[..., i] for i in range(2 - words, 2))
    pkeys = tuple(probe[..., i] for i in range(2 - words, 2))
    found = _same_on_card((keys, None, dim[..., 2], pkeys, None), d * m)
    assert int(found.sum()) == d * (p - p // 4)


@pytest.mark.cuda
@pytest.mark.parametrize("words", [1, 2])
def test_kernel_flags_past_its_bound(cuda, words):
    """More live dimension rows than the bound: the flag is set, the call
    ends, and nothing is found, whether the table still holds them (bound
    just short) or not (a bound of 3 against a million rows)."""
    gen = torch.Generator(device=cuda).manual_seed(words)
    dim, dim_v = _received(4, 300_000, 250_000, 3, gen)
    dim[..., 0] &= 0x3FFFFFFF
    probe, probe_v = dim.clone(), dim_v.clone()
    keys = tuple(dim[..., i] for i in range(words))
    pkeys = tuple(probe[..., i] for i in range(words))
    taking = _taking(keys, dim_v)
    for bound in (taking - 1, 3):
        attr, found, over = hl.hash_lookup(keys, dim_v, dim[..., 2], pkeys,
                                           probe_v, bound)
        torch.cuda.synchronize()
        assert over.all() and not found.any() and not attr.any()
    _, found, over = hl.hash_lookup(keys, dim_v, dim[..., 2], pkeys, probe_v,
                                    taking)
    assert not over.any() and bool(found[dim_v].all())


@pytest.mark.cuda
def test_kernel_never_sorts_and_counts_while_profiled(cuda, monkeypatch):
    from torch.profiler import ProfilerActivity, profile

    def refuse(*args, **kwargs):
        raise AssertionError("a sort or a search on the lookup's path")

    c = _case("pairs_wide")
    args = _args(c, cuda)
    for name in ("sort", "argsort", "searchsorted"):
        monkeypatch.setattr(torch, name, refuse)
    assert not trace.counting()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        _, found, _ = hl.hash_lookup(*args, bound=10**6)
    torch.cuda.synchronize()
    monkeypatch.undo()
    got = trace.counts()
    assert got["lookup.probes"] == _taking(args[3], args[4])
    assert got["lookup.found"] == int(found.sum()) > 0
