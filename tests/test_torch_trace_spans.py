"""The port's one span entry (``utils/trace.span``) and its counters.

A span opens a ``record_function`` range only while a torch profiler
records, and a Tracer event only while its tracer is enabled; with
neither, a step enters the dispatcher for no span. The step paths that
the benchmark's cells run emit the spans its readers select on (the row
gather, the grouping, the receive fill, q95's aggregate sort, q64's
joins, groupings and pair lookups, ALS's shuffles, normal equations and
solves), and count the bytes their gathers and exchanges move, the probes
their lookups answer, and ALS's rounds, ratings, entities and sums'
bytes. Here on the CPU, at small sizes of the cells' own configurations,
with the benchmark's readers run on synthetic summaries.
"""

from __future__ import annotations

import json
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmarks import harness  # noqa: E402
from benchmarks.jobs import als as als_job  # noqa: E402
from benchmarks.reference import als as als_reference  # noqa: E402
from benchmarks.jobs import q64 as q64_job  # noqa: E402
from benchmarks.jobs import q95 as q95_job  # noqa: E402
from benchmarks.jobs import terasort as terasort_job  # noqa: E402
from sparkrdma_tpu_torch.ops.normal_equations import PIECE_ROWS  # noqa: E402
from sparkrdma_tpu_torch.parallel import device_plane  # noqa: E402
from sparkrdma_tpu_torch.parallel import exchange  # noqa: E402
from sparkrdma_tpu_torch.parallel.mesh import VirtualMesh, take_rows  # noqa: E402
from sparkrdma_tpu_torch.utils import trace  # noqa: E402
from sparkrdma_tpu_torch.utils.trace import Tracer  # noqa: E402
from sparkrdma_tpu_torch.utils.u32 import rows_from_numpy  # noqa: E402

# the cells' configurations cut to a CPU test's size
SMALL = {
    "q95": ("tpcds-sf1", {
        "web_sales_rows": 16000, "ws_rows_per_device": 2000,
        "orders": 1500, "customer_address_rows": 300, "states": 3,
        "target_state": 2, "companies": 2, "web_site_rows": 6,
        "ship_span_days": 150, "window_start_day": 35830}),
    "terasort": ("terasort-hibench-large", {"rows_per_device": 1500}),
    "q64": ("tpcds-sf10-q64", {
        "store_sales_rows": 4003, "ss_rows_per_device": 501,
        "store_returns_rows": 399, "catalog_sales_rows": 2001,
        "cs_rows_per_device": 251, "catalog_returns_rows": 200,
        "date_dim_rows": 730, "num_dates": 730}),
    "als": ("als-netflix-mllib", {
        "ratings": 6003, "users": 300, "items": 120, "rows_per_shard": 601,
        "quota": 64}),
}
JOBS = {"q95": q95_job, "terasort": terasort_job, "q64": q64_job,
        "als": als_job}


def _profile():
    return profile(activities=[ProfilerActivity.CPU])


def _fresh() -> None:
    """A call with no profiler running: the next counted call starts the
    counters from zero."""
    assert not trace.counting()


def _job(kind: str, impl: str, monkeypatch):
    """``(cfg, run)``: the cell's small configuration and one job of the
    port's step on it, its transport resolved to ``impl``."""
    name, cut = SMALL[kind]
    cfg = dict(harness.load_config(name), **cut)
    resolve = exchange.resolve_impl
    monkeypatch.setattr(exchange, "resolve_impl", lambda device, want="auto":
                        resolve(device, impl if want == "auto" else want))
    job = JOBS[kind]
    inputs = job.make_inputs(cfg, 11, "cpu")
    step, transport = job._port_step(cfg, "cpu")
    assert transport == impl
    if kind == "q95":
        return cfg, lambda: step(inputs["ws"], inputs["wr"], inputs["date"],
                                 inputs["addr"], inputs["site"])
    if kind == "q64":
        return cfg, lambda: step(inputs["ss"], inputs["sr"], inputs["cs"],
                                 inputs["cr"], inputs["date"])
    if kind == "als":
        return cfg, lambda: step(inputs["ratings"], inputs["inits"][0])
    return cfg, lambda: step(inputs["rows"])


# -- the spans the cells' readers select on ----------------------------------

@pytest.mark.parametrize("kind,names", [
    ("q95", {"mesh.take_rows", "exchange.group", "exchange.receive_fill",
             "exchange.transport", "q95.aggregate", "q95.aggregate.sort",
             "lookup.unique"}),
    ("terasort", {"mesh.take_rows", "exchange.receive_fill",
                  "exchange.transport", "fused.local_sort",
                  "fused.receive_sort"}),
    ("q64", {"mesh.take_rows", "exchange.group", "exchange.receive_fill",
             "exchange.transport", "q64.catalog_join", "q64.catalog_group",
             "q64.store_join", "q64.by_item", "q64.pair_lookup",
             "lookup.unique"}),
    ("als", {"mesh.take_rows", "exchange.group", "exchange.receive_fill",
             "exchange.transport", "als.group", "als.solve", "als.gram",
             "chunked.slot_fill", "chunked.pack", "chunked.transport",
             "chunked.land"}),
])
def test_a_profiled_step_emits_its_spans(kind, names, monkeypatch):
    _, run = _job(kind, "native", monkeypatch)
    with _profile() as prof:
        run()
    emitted = {e.key for e in prof.key_averages()}
    assert names <= emitted
    assert "fused.exchange" not in emitted


# ops that launch no kernel on the card
_VIEWS = {"aten::select", "aten::slice", "aten::reshape", "aten::view",
          "aten::unsqueeze", "aten::expand", "aten::t", "aten::as_strided",
          "aten::_reshape_alias", "aten::alias", "aten::detach"}
# the spans the benchmark's readers take device time from
_READ = {"q95.date", "q95.addr", "q95.site", "q95.by_order", "q95.aggregate",
         "q95.aggregate.sort", "exchange.group", "exchange.receive_fill",
         "exchange.transport", "mesh.take_rows", "fused.local_sort",
         "fused.receive_sort", "q64.catalog_join", "q64.store_join",
         "q64.catalog_group", "q64.by_item", "q64.pair_lookup",
         "lookup.unique", "als.group", "als.solve", "als.gram",
         "chunked.slot_fill", "chunked.pack", "chunked.transport",
         "chunked.land"}
# how many of them each step opens
_READ_IN = {"q95": 11, "terasort": 5, "q64": 10, "als": 11}


@pytest.mark.parametrize("kind", ["q95", "terasort", "q64", "als"])
def test_a_read_span_opens_and_closes_on_its_own_work(kind, monkeypatch):
    """On the card a kernel belongs to the innermost open span, and a span's
    range runs from its first to its last own kernel: each span a reader
    takes device time from starts and ends with an op of its own, so its
    range covers the spans nested in it (q95's aggregate sort, q64's pair
    lookups, every lookup's ``lookup.unique``, ALS's ``als.gram`` and the
    sorts' row gathers)."""
    _, run = _job(kind, "native", monkeypatch)
    with _profile() as prof:
        run()
    checked = set()
    for event in prof.events():
        if event.name not in _READ:
            continue
        ops = [c for c in sorted(event.cpu_children,
                                 key=lambda c: c.time_range.start)
               if c.name not in _VIEWS]
        assert ops, event.name
        assert not ops[0].is_user_annotation, (event.name, ops[0].name)
        assert not ops[-1].is_user_annotation, (event.name, ops[-1].name)
        checked.add(event.name)
    assert len(checked) == _READ_IN[kind]


def _count_enters(monkeypatch) -> list:
    calls = []
    enter = torch.ops.profiler._record_function_enter_new

    def counted(*args, **kwargs):
        calls.append(args[0])
        return enter(*args, **kwargs)

    monkeypatch.setattr(torch.ops.profiler, "_record_function_enter_new",
                        counted)
    return calls


@pytest.mark.parametrize("kind", ["q95", "terasort", "round_driver"])
def test_no_profiler_no_record_function(kind, monkeypatch):
    """With no profiler running a step (and a round driver whose tracer
    records) enters ``record_function`` zero times; under a profiler the
    same call enters it for every span."""
    if kind == "round_driver":
        rng = np.random.default_rng(3)
        rows = rng.integers(0, 2**32, size=(8 * 60, 4), dtype=np.uint32)
        dest = rng.integers(0, 8, size=len(rows)).astype(np.int32)
        tracer = Tracer()

        def run():
            device_plane.run_fused_exchange(
                VirtualMesh(8, "cpu"), rows, dest, key_words=2, impl="ring",
                out_factor=4, rows_per_round=30, tracer=tracer)
    else:
        _, run = _job(kind, "native", monkeypatch)
    calls = _count_enters(monkeypatch)
    run()
    assert calls == []
    if kind == "round_driver":
        assert len(tracer.events("exchange.round")) == 2
    with _profile():
        run()
    assert "mesh.take_rows" in calls and "exchange.transport" in calls


def test_the_helper_is_one_shared_no_op_when_off():
    assert trace.span("mesh.take_rows") is trace.span("exchange.group")
    assert trace.span("exchange.round", trace.NULL, round=1) is \
        trace.span("exchange.round", None)
    tracer = Tracer()
    with trace.span("exchange.round", tracer, round=4, rows=9):
        pass
    (event,) = tracer.events("exchange.round")
    assert (event["cat"], event["ph"], event["args"]) == (
        "exchange", "X", {"round": 4, "rows": 9})


def _model_step(kind: str):
    """One step of a model the port runs on ``native``, at a CPU test's
    size, and the shuffles that step makes."""
    from sparkrdma_tpu_torch.models import join, pagerank, terasort, tpcds
    from sparkrdma_tpu_torch.models import tpcds_queries

    vmesh = VirtualMesh(8, "cpu")
    if kind == "q95":
        cfg = tpcds_queries.Q95Config(ws_rows_per_device=64, num_orders=100)
        return 8, lambda: tpcds_queries.run_q95(vmesh, cfg, seed=2,
                                                impl="native")
    if kind == "terasort":
        cfg = terasort.TeraSortConfig(64, 2)
        step = terasort.make_terasort_step(vmesh, cfg, "native")
        rows = rows_from_numpy(terasort.generate_rows(cfg, 8, 2), vmesh)
        return 1, lambda: step(rows)
    if kind == "star_join":
        cfg = tpcds.TpcdsConfig(fact_rows_per_device=64, dim1_size=50,
                                dim2_size=40)
        return 5, lambda: tpcds.run_tpcds(vmesh, cfg, seed=2, impl="native")
    if kind == "shuffle_join":
        cfg = join.JoinConfig(64, 64, 100)
        return 2, lambda: join.run_join(vmesh, cfg, seed=2, impl="native")
    cfg = pagerank.PageRankConfig(num_vertices=64, edges_per_device=32)
    return 1, lambda: pagerank.run_pagerank(vmesh, cfg, 1, seed=2,
                                            impl="native")


@pytest.mark.parametrize("kind", ["q95", "terasort", "star_join",
                                  "shuffle_join", "pagerank"])
def test_each_shuffle_fills_one_receive_buffer(kind):
    """Every model step builds its receive buffers through
    ``exchange.receive_buffer``: a profiled step opens one
    ``exchange.receive_fill`` for each shuffle it makes (one
    ``exchange.transport`` each on ``native``)."""
    shuffles, run = _model_step(kind)
    with _profile() as prof:
        run()
    names = [e.name for e in prof.events()]
    assert names.count("exchange.transport") == shuffles
    assert names.count("exchange.receive_fill") == shuffles


# -- one clock ---------------------------------------------------------------

def test_a_tracer_span_lies_inside_its_profiler_range(tmp_path):
    """The Tracer stamps Unix-epoch µs, the clock of a profiler export
    (``ts`` plus ``baseTimeNanoseconds / 1000``), so each span the helper
    records lies inside the ``record_function`` range it opened."""
    tracer = Tracer()
    with trace.device_profile(str(tmp_path)):
        for r in range(4):
            with trace.span("exchange.round", tracer, round=r):
                torch.ones(256).cumsum(0)
    exported = json.loads(next(tmp_path.glob("trace_*.json")).read_text())
    base = exported["baseTimeNanoseconds"] / 1e3
    ranges = sorted((float(e["ts"]) + base,
                     float(e["ts"]) + float(e["dur"]) + base)
                    for e in exported["traceEvents"]
                    if e.get("name") == "exchange.round"
                    and e.get("ph") == "X")
    spans = sorted((e["ts"], e["ts"] + e["dur"])
                   for e in tracer.events("exchange.round"))
    assert len(ranges) == len(spans) == 4
    for (lo, hi), (start, end) in zip(ranges, spans):
        assert lo <= start <= end <= hi


# -- the counters ------------------------------------------------------------

@pytest.mark.parametrize("shape,dtype,picks", [
    ((8, 50, 7), torch.int32, 30),
    ((4, 20), torch.int64, 5),
    ((2, 10, 3, 2), torch.float32, 10),
    ((3, 6, 25), torch.int32, 0),
])
def test_the_gather_counter_is_the_bytes_of_its_shapes(shape, dtype, picks):
    rows = torch.arange(math.prod(shape)).reshape(shape).to(dtype)
    idx = torch.randint(0, shape[1], (shape[0], picks), dtype=torch.int32)
    row_bytes = math.prod(shape[2:]) * rows.element_size()
    _fresh()
    with _profile():
        got = take_rows(rows, idx)
        take_rows(rows, idx)
    assert torch.equal(got, torch.stack([rows[d, idx[d].long()]
                                         for d in range(shape[0])]))
    want = 2 * idx.numel() * (2 * row_bytes + 8)
    assert trace.counts().get("gather.bytes", 0) == want


def test_counters_hold_only_the_last_profiled_window():
    rows = torch.zeros((2, 8, 4), dtype=torch.int32)
    idx = torch.zeros((2, 3), dtype=torch.int64)
    one = idx.numel() * (2 * 16 + 8)
    _fresh()
    with _profile():
        take_rows(rows, idx)
    take_rows(rows, idx)                       # no profiler: not counted
    assert trace.counts()["gather.bytes"] == one
    with _profile():
        take_rows(rows, idx)
        take_rows(rows, idx)
    assert trace.counts()["gather.bytes"] == 2 * one
    with _profile():                           # no unprofiled call between
        take_rows(rows, idx)
    assert trace.counts()["gather.bytes"] == 3 * one


@pytest.mark.parametrize("kind", ["q95", "terasort", "als"])
@pytest.mark.parametrize("impl", ["native", "gather"])
def test_the_transport_counter_is_the_jobs_exchange_bytes(kind, impl,
                                                          monkeypatch):
    """The program's count of the bytes its exchanges route (each row
    read once and written once, dead rows too) is the job module's
    ``exchange_bytes``, a job; its gathers' count is the job's
    ``take_rows`` shapes."""
    cfg, run = _job(kind, impl, monkeypatch)
    _fresh()
    with _profile():
        run()
        run()
    got = trace.counts()
    assert got["exchange.bytes"] == 2 * JOBS[kind].exchange_bytes(cfg)
    assert got["gather.bytes"] > 0


@pytest.mark.parametrize("impl", ["native", "gather"])
def test_the_group_counter_is_the_bytes_of_its_groupings(impl, monkeypatch):
    """Each grouping counts its partition (each destination read, each
    index written) and its row gather (as ``gather.bytes`` counts it),
    from shapes: a q95 job's groupings add up their shapes' bytes, and
    their gathers are part of the job's ``gather.bytes``."""
    groupings = []
    inner = exchange.group_by_destination

    def recorded(data, dest, num_partitions):
        row_bytes = math.prod(data.shape[2:]) * data.element_size()
        groupings.append((dest.numel(), dest.element_size(), row_bytes))
        return inner(data, dest, num_partitions)

    monkeypatch.setattr(exchange, "group_by_destination", recorded)
    cfg, run = _job("q95", impl, monkeypatch)
    _fresh()
    with _profile():
        run()
    got = trace.counts()
    assert len(groupings) == 8
    assert got["exchange.group_bytes"] == sum(
        n * (dest_bytes + 8) + n * (2 * row_bytes + 8)
        for n, dest_bytes, row_bytes in groupings)
    gathers = sum(n * (2 * row_bytes + 8) for n, _, row_bytes in groupings)
    assert 0 < gathers < got["gather.bytes"]


def test_the_transport_counter_adds_on_the_device_with_no_sync():
    data = torch.zeros((3, 5, 2), dtype=torch.int32)
    mat = torch.tensor([[1, 2, 0], [0, 0, 5], [1, 1, 1]], dtype=torch.int32)
    _fresh()
    with _profile():
        exchange.ragged_exchange_shard(data, mat, impl="native")
    assert trace._counts["exchange.bytes"].dtype == torch.int64
    assert trace.counts() == {"exchange.bytes": 11 * 8 * 2}


@pytest.mark.parametrize("kind", ["q95", "q64"])
def test_the_lookup_counters_count_only_while_profiled(kind, monkeypatch):
    """Each lookup counts its probes that take part (``lookup.probes``)
    and those it finds (``lookup.found``), on the device as tensors, and
    only while a profiler records: a job's counts are what its lookups
    return, and a job run with no profiler adds nothing."""
    from sparkrdma_tpu_torch.ops import hash_lookup

    answered = []
    inner = hash_lookup.hash_lookup

    def recorded(dim_keys, dim_valid, dim_attr, probe_keys, probe_valid,
                 bound):
        got = inner(dim_keys, dim_valid, dim_attr, probe_keys, probe_valid,
                    bound)
        first = probe_keys[0].to(torch.int64) & 0xFFFFFFFF
        key = (first < hash_lookup.HIGH_LIMIT if len(probe_keys) == 2
               else first != hash_lookup.NO_KEY)
        if probe_valid is not None:
            key &= probe_valid
        answered.append((int(key.sum()),
                         int(got[1].sum())))
        return got

    from sparkrdma_tpu_torch.models import tpcds_queries
    monkeypatch.setattr(tpcds_queries, "hash_lookup", recorded)
    _, run = _job(kind, "native", monkeypatch)
    _fresh()
    with _profile():
        run()
    assert trace._counts["lookup.probes"].dtype == torch.int64
    got = trace.counts()
    assert len(answered) == {"q95": 4, "q64": 4}[kind]
    assert got["lookup.probes"] == sum(p for p, _ in answered) > 0
    assert got["lookup.found"] == sum(f for _, f in answered) > 0
    assert got["lookup.found"] < got["lookup.probes"]
    run()                                      # no profiler: not counted
    assert trace.counts() == got


def test_the_gram_nests_in_the_solve_on_its_own_work(monkeypatch):
    """Each shard's ``als.gram`` lies inside its half-step's ``als.solve``,
    and ``als.solve`` runs ops of its own before the first and after the
    last, so its range on the card covers every nested sum."""
    cfg, run = _job("als", "native", monkeypatch)
    with _profile() as prof:
        run()
    events = prof.events()
    solves = [e for e in events if e.name == "als.solve"]
    grams = [e for e in events if e.name == "als.gram"]
    assert len(solves) == 2 and len(grams) == 2 * cfg["shards"]
    assert all(g.cpu_parent is not None and g.cpu_parent.name == "als.solve"
               for g in grams)
    for solve in solves:
        ops = [c for c in sorted(solve.cpu_children,
                                 key=lambda c: c.time_range.start)
               if c.name not in _VIEWS]
        names = [op.name for op in ops]
        first = names.index("als.gram")
        last = len(names) - 1 - names[::-1].index("als.gram")
        assert not any(op.is_user_annotation for op in ops[:first])
        assert first > 0 and last < len(ops) - 1
        assert not any(op.is_user_annotation for op in ops[last + 1:])


@pytest.mark.parametrize("impl", ["native", "gather"])
def test_the_als_counters_count_a_job(impl, monkeypatch):
    """Under a profiler one job counts its chunked rounds, every live
    rating once a half-step, every rated entity once, the sums' bytes
    of those shapes (``gram_bytes``) and the entities whose rows take more
    than one piece of the sums (none at this size); a job run with no
    profiler adds nothing."""
    cfg, run = _job("als", impl, monkeypatch)
    rows = als_job.make_inputs(cfg, 11, "cpu")["ratings"]
    live = rows.reshape(-1, 3)[:cfg["ratings"]]
    assert (live[:, 0].unique().numel() + live[:, 1].unique().numel()
            == cfg["items"] + cfg["users"])
    # a shuffle's rounds: its largest (shard, block) pair over the quota
    rounds = sum(-(-max(int(torch.bincount(s[s[:, col] >= 0, col] % 10,
                                           minlength=10).max())
                        for s in rows) // cfg["quota"])
                 for col in (0, 1))
    _fresh()
    with _profile():
        run()
    got = trace.counts()
    # entities whose rows take more than one of the kernel's pieces
    split = sum(int((torch.bincount(live[:, col]) > PIECE_ROWS).sum())
                for col in (0, 1))
    assert {k: v for k, v in got.items() if k.startswith("als.")} == {
        "als.rounds": rounds, "als.ratings": 2 * cfg["ratings"],
        "als.entities": cfg["items"] + cfg["users"],
        "als.gram_bytes": als_job.gram_bytes(cfg), "als.gram_split": split}
    assert rounds >= 4
    run()                                      # no profiler: not counted
    assert trace.counts() == got


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_a_weighted_half_step_on_the_card_equals_the_reference(cuda):
    """One weighted item half-step at D = 10 on the card (the native
    transport, the partition and row gather kernels, float32 atomics)
    against the float64 reference, each entity within the cell's limit."""
    from sparkrdma_tpu_torch.models.als import ALSConfig, als_half_step

    cfg = dict(harness.load_config("als-netflix-mllib"), ratings=2_000_003,
               users=40_000, items=2_000, rows_per_shard=200_001,
               quota=1 << 13)
    inputs = als_job.make_inputs(cfg, 2**40 + 7, cuda)
    users = inputs["inits"][0]
    port = ALSConfig(num_users=cfg["users"], num_items=cfg["items"],
                     rank=cfg["rank"], reg=cfg["reg"], weighted_reg=True)
    items, rounds = als_half_step(VirtualMesh(10, cuda), port,
                                  inputs["ratings"], users, cfg["quota"])
    want = als_reference.half_step(inputs["ratings"], torch.from_numpy(users),
                                   key_col=0, num_out=cfg["items"],
                                   reg=cfg["reg"])
    err = als_job.relative_errors(items, want)
    assert rounds >= 2
    assert float(err.max()) <= als_job.ERR_LIMIT


# -- the benchmark's readers on a synthetic summary ---------------------------

def _ctx(spans_us: dict, jobs: int = 2) -> harness.Context:
    summary = harness.TraceSummary(jobs, 1.0, 0.5, spans_us, [], [])
    return harness.Context(summary, [0.002], exchange_bytes=10**6)


GB = 10**9
SPANS = {"mesh.take_rows": 8000.0, "exchange.receive_fill": 600.0,
         "exchange.group": 3000.0, "q95.aggregate.sort": 4200.0,
         "fused.receive_sort": 9000.0, "q64.catalog_join": 1000.0,
         "q64.store_join": 3000.0, "q64.catalog_group": 500.0,
         "q64.by_item": 700.0, "q64.pair_lookup": 1800.0,
         "lookup.unique": 2600.0, "als.group": 400.0,
         "chunked.slot_fill": 300.0, "chunked.pack": 200.0,
         "chunked.transport": 100.0, "chunked.land": 1000.0,
         "als.gram": 5000.0, "als.solve": 6000.0}
COUNTS = {"gather.bytes": 2 * 6 * GB, "exchange.bytes": 2 * 3 * GB,
          "fused.merge_bytes": 2 * 9.6 * GB,
          "exchange.group_bytes": 2 * 6.1 * GB,
          "als.gram_bytes": 2 * 9.8 * GB}


@pytest.mark.parametrize("metric,want", [
    ("gather.rows_ms", 4.0),
    ("exchange.receive_fill_ms", 0.3),
    ("exchange.group_ms", 1.5),
    ("q95.aggregate_sort_ms", 2.1),
    ("q64.pair_joins_ms", 2.0),
    ("q64.item_groups_ms", 0.6),
    ("q64.pair_lookup_ms", 0.9),
    ("lookup.unique_ms", 1.3),
    ("als.shuffle_ms", 1.0),
    ("als.gram_ms", 2.5),
    ("als.solve_ms", 3.0),
    ("gather.gb", 6.0),
    ("exchange.gb", 3.0),
    # 6 GB at 3.35 TB/s over 4 ms
    ("gather_roofline", 100 * 6 * GB / 3.35e12 / 4e-3),
    # 9.6 GB at 3.35 TB/s over 4.5 ms
    ("device_plane.receive_merge_roofline",
     100 * 9.6 * GB / 3.35e12 / 4.5e-3),
    # 6.1 GB at 3.35 TB/s over 1.5 ms
    ("exchange.group_roofline", 100 * 6.1 * GB / 3.35e12 / 1.5e-3),
    # 9.8 GB at 3.35 TB/s over 2.5 ms
    ("als.gram_roofline", 100 * 9.8 * GB / 3.35e12 / 2.5e-3),
])
def test_a_reader_on_a_synthetic_summary(metric, want, monkeypatch):
    reader = harness.load_readers()[metric]
    monkeypatch.setattr(trace, "counts", lambda: dict(COUNTS))
    assert reader.read(_ctx(SPANS)) == pytest.approx(want)
    # nothing to read: no span, no count, or a program without counters
    monkeypatch.setattr(trace, "counts", dict)
    assert reader.read(_ctx({})) is None
    monkeypatch.delattr(trace, "counts")
    if metric.endswith("_ms"):
        assert reader.read(_ctx(SPANS)) == pytest.approx(want)
    else:
        assert reader.read(_ctx(SPANS)) is None
