"""Parity of the port's TPC-DS q95 and q64 (``sparkrdma_tpu_torch.models.
tpcds_queries``) with the JAX package's on-mesh steps and numpy oracles:
the generators are bit-equal, the per-shard partials equal the JAX
step's for every transport (the port's ring through its plain version on
the CPU; the JAX side on ``dense`` and ``gather``, since its step keeps
``shard_map``'s varying-axes check, which rejects the interpret-mode
ring), the totals equal both oracles, the order- and item-level
predicates bite, and an under-sized ``out_factor`` overflows in both
packages. The JAX side runs on the conftest's 8-device CPU mesh."""

import jax
import numpy as np
import pytest
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from sparkrdma_tpu.models import tpcds_queries as jq
from sparkrdma_tpu_torch.models import tpcds_queries as tq
from sparkrdma_tpu_torch.parallel.mesh import VirtualMesh
from sparkrdma_tpu_torch.utils.u32 import rows_from_numpy

D = 8
# the JAX package's test configurations (tests/test_tpcds.py)
Q95 = tq.Q95Config(ws_rows_per_device=768, num_orders=600, out_factor=3)
Q64 = tq.Q64Config(ss_rows_per_device=640, cs_rows_per_device=512,
                   num_items=300, out_factor=4)
Q95_SEED, Q64_SEED = 9, 13
PAIRS = [("ring", "dense"), ("dense", "dense"), ("gather", "gather"),
         ("native", "gather")]


@pytest.fixture(scope="module")
def mesh():
    return Mesh(np.array(jax.devices()[:D]), ("shuffle",))


@pytest.fixture(scope="module")
def vmesh():
    return VirtualMesh(D, "cpu")


def _jcfg(cfg):
    cls = jq.Q95Config if isinstance(cfg, tq.Q95Config) else jq.Q64Config
    return cls(**cfg.__dict__)


def _tables(cfg, seed):
    gen = tq.generate_q95 if isinstance(cfg, tq.Q95Config) \
        else tq.generate_q64
    return gen(cfg, D, seed)


_JAX = {}


def _jax_partials(mesh, cfg, impl, seed):
    """The JAX step's per-shard partials and overflow flags, one compile
    and run per (config, transport, seed) in this module."""
    key = (cfg, impl, seed)
    if key not in _JAX:
        make = jq.make_q95_step if isinstance(cfg, tq.Q95Config) \
            else jq.make_q64_step
        step = make(mesh, "shuffle", _jcfg(cfg), impl)
        sh = NamedSharding(mesh, P("shuffle"))
        out = step(*(jax.device_put(jq.pad_rows_to_devices(t, D), sh)
                     for t in _tables(cfg, seed)))
        _JAX[key] = tuple(np.asarray(a) for a in out)
    return _JAX[key]


def _port_partials(vmesh, cfg, impl, seed):
    make = tq.make_q95_step if isinstance(cfg, tq.Q95Config) \
        else tq.make_q64_step
    step = make(vmesh, cfg, impl)
    out = step(*(rows_from_numpy(tq.pad_rows_to_devices(t, D), vmesh)
                 for t in _tables(cfg, seed)))
    return tuple(t.numpy() for t in out)


def test_generators_match_jax():
    for cfg, seed in ((Q95, Q95_SEED), (Q64, Q64_SEED)):
        jgen = jq.generate_q95 if cfg is Q95 else jq.generate_q64
        for got, want in zip(_tables(cfg, seed), jgen(_jcfg(cfg), D, seed)):
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
    rows = np.arange(30, dtype=np.uint32).reshape(15, 2)
    for n in (1, 4, 8, 32):
        np.testing.assert_array_equal(tq.pad_rows_to_devices(rows, n),
                                      jq.pad_rows_to_devices(rows, n))


@pytest.mark.parametrize("cfg,seed", [(Q95, Q95_SEED), (Q64, Q64_SEED)],
                         ids=["q95", "q64"])
@pytest.mark.parametrize("port_impl,jax_impl", PAIRS)
def test_step_partials_match_jax(mesh, vmesh, cfg, seed, port_impl,
                                 jax_impl):
    got = _port_partials(vmesh, cfg, port_impl, seed)
    want = _jax_partials(mesh, cfg, jax_impl, seed)
    for name, g, w in zip(("partials", "overflowed"), got, want):
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    assert not got[1].any()
    # each order (item) lives on one shard: the partials are the
    # oracle's per-owner split
    by_shard = tq.numpy_q95_by_shard if cfg is Q95 else tq.numpy_q64_by_shard
    np.testing.assert_array_equal(
        got[0].astype(np.int64), by_shard(*_tables(cfg, seed), cfg, D))


@pytest.mark.parametrize("impl", ["ring", "dense", "gather"])
def test_runs_match_oracles(vmesh, impl):
    q95 = tq.run_q95(vmesh, Q95, seed=Q95_SEED, impl=impl)
    want = jq.numpy_q95(*_tables(Q95, Q95_SEED), _jcfg(Q95))
    assert q95 == want == tq.numpy_q95(*_tables(Q95, Q95_SEED), Q95)
    assert want[0] > 0, "degenerate q95: no qualifying orders"
    q64 = tq.run_q64(vmesh, Q64, seed=Q64_SEED, impl=impl)
    want = jq.numpy_q64(*_tables(Q64, Q64_SEED), _jcfg(Q64))
    assert q64 == want == tq.numpy_q64(*_tables(Q64, Q64_SEED), Q64)
    assert want[0] > 0, "degenerate q64: no qualifying items"


def test_runs_take_pregenerated_tables(vmesh):
    tables = tq.generate_q95(Q95, D, 4)
    assert tq.run_q95(vmesh, Q95, tables=tables) == tq.run_q95(
        vmesh, Q95, seed=4)
    tables = tq.generate_q64(Q64, D, 4)
    assert tq.run_q64(vmesh, Q64, tables=tables) == tq.run_q64(
        vmesh, Q64, seed=4)


def test_q95_returns_semi_join_bites(vmesh):
    """The self-semi-join and the returns semi-join both bite: with every
    order returned more orders qualify, on the card's path and in both
    oracles."""
    ws, wr, date, addr, site = _tables(Q95, Q95_SEED)
    all_returned = np.arange(Q95.num_orders, dtype=np.uint32).reshape(-1, 1)
    loose = tq.run_q95(vmesh, Q95, tables=(ws, all_returned, date, addr,
                                           site))
    assert loose == jq.numpy_q95(ws, all_returned, date, addr, site,
                                 _jcfg(Q95))
    assert loose[0] > tq.numpy_q95(ws, wr, date, addr, site, Q95)[0], \
        "returns semi-join filtered nothing"


def test_q64_having_predicate_bites(vmesh):
    """cs_ui's HAVING sum(sale) > 2*sum(refund) excludes the
    returns-heavy items: without catalog returns more items qualify."""
    ss, sr, cs, cr, date = _tables(Q64, Q64_SEED)
    no_refunds = jq.numpy_q64(ss, sr, cs, cr[:0], date, _jcfg(Q64))
    zero_refunds = cr.copy()
    zero_refunds[:, 2] = 0
    assert tq.run_q64(vmesh, Q64, tables=(ss, sr, cs, zero_refunds,
                                          date)) == no_refunds
    assert tq.numpy_q64(ss, sr, cs, cr, date, Q64)[0] < no_refunds[0], \
        "HAVING filtered nothing"


def test_numpy_oracles_match_jax_on_edges():
    """The vectorised oracles against the JAX package's per-row loops
    where keys fall outside every dimension, and on empty returns."""
    ws, wr, date, addr, site = tq.generate_q95(Q95, D, 21)
    ws[::7, 2] = 9999   # ship date outside date_dim
    ws[::11, 3] = 9999  # address outside customer_address
    for tables in ((ws, wr, date, addr, site), (ws, wr[:0], date, addr,
                                                 site)):
        assert tq.numpy_q95(*tables, Q95) == jq.numpy_q95(*tables,
                                                          _jcfg(Q95))
    ss, sr, cs, cr, date = tq.generate_q64(Q64, D, 22)
    ss[::5, 2] = 9999
    for tables in ((ss, sr, cs, cr, date), (ss, sr[:0], cs, cr, date)):
        assert tq.numpy_q64(*tables, Q64) == jq.numpy_q64(*tables,
                                                          _jcfg(Q64))


@pytest.mark.parametrize("impl", ["dense", "gather"])
def test_overflow_at_undersized_out_factor(mesh, vmesh, impl):
    """``out_factor`` 1 leaves no headroom for hash skew: both packages
    flag the same shards, and the runners raise."""
    for cfg, seed, jrun, trun in (
            (Q95, Q95_SEED, jq.run_q95, tq.run_q95),
            (Q64, Q64_SEED, jq.run_q64, tq.run_q64)):
        tight = type(cfg)(**{**cfg.__dict__, "out_factor": 1})
        got = _port_partials(vmesh, tight, impl, seed)[1]
        want = _jax_partials(mesh, tight, impl, seed)[1]
        assert want.any()
        np.testing.assert_array_equal(got, want)
        with pytest.raises(OverflowError):
            trun(vmesh, tight, seed=seed, impl=impl)
        if impl == "dense":  # one more JAX compile per query is enough
            with pytest.raises(OverflowError):
                jrun(mesh, _jcfg(tight), seed=seed, impl=impl)


# -- the DAG-engine plans (build_q95_job, build_q64_job) -------------------

@pytest.fixture(scope="module")
def clusters(tmp_path_factory):
    """Per package: a compat driver and 3 executors, for the module."""
    from sparkrdma_tpu.config import TpuShuffleConf as JConf
    from sparkrdma_tpu.shuffle.spark_compat import (
        SparkCompatShuffleManager as JCompat,
    )
    from sparkrdma_tpu_torch.config import TpuShuffleConf as TConf
    from sparkrdma_tpu_torch.shuffle.spark_compat import (
        SparkCompatShuffleManager as TCompat,
    )

    tmp = tmp_path_factory.mktemp("torch_queries_engine")
    made = {}
    try:
        for pkg, compat, conf_cls in (("jax", JCompat, JConf),
                                      ("port", TCompat, TConf)):
            conf = conf_cls(connect_timeout_ms=1000,
                            max_connection_attempts=2)
            driver = compat(conf, isDriver=True)
            made[pkg] = (driver, [])
            for i in range(3):
                made[pkg][1].append(compat(
                    conf, driverAddr=driver.driverAddr, executorId=str(i),
                    spill_dir=str(tmp / f"{pkg}{i}")))
            for ex in made[pkg][1]:
                ex.native.executor.wait_for_members(3)
        yield made
    finally:
        for driver, execs in made.values():
            for ex in execs:
                ex.stop()
            driver.stop()


@pytest.mark.parametrize("plane", ["mesh", "ring", "host"])
@pytest.mark.parametrize("query,seed,shuffles",
                         [("q95", Q95_SEED, 7), ("q64", Q64_SEED, 8)])
def test_engine_job_matches_jax_and_oracle(clusters, mesh, vmesh, plane,
                                           query, seed, shuffles):
    """The engine plan on the port's engine, every shuffle on the mesh
    (``auto``, or ``ring``, the card's transport) or on the host plane,
    equals the JAX engine's run of the JAX builder on the same plane and
    the numpy oracle (``tests/test_tpcds.py``'s sizes: 3 maps, 4
    partitions, data scale 8); on the mesh no shuffle degrades."""
    from sparkrdma_tpu.engine import DAGEngine as JEngine
    from sparkrdma_tpu_torch.engine import DAGEngine as TEngine
    from sparkrdma_tpu_torch.parallel import exchange as texchange
    from sparkrdma_tpu_torch.utils.trace import Tracer

    cfg = Q95 if query == "q95" else Q64
    kw = dict(num_maps=3, num_partitions=4, seed=seed, data_scale=8)
    job, finish = getattr(jq, f"build_{query}_job")(_jcfg(cfg), **kw)
    on_mesh = plane != "host"
    want_jax = finish(JEngine(*clusters["jax"],
                              mesh=mesh if on_mesh else None).run(job))
    before = texchange.DATA_PLANE["exchanges"]
    job, finish = getattr(tq, f"build_{query}_job")(cfg, **kw)
    engine = TEngine(*clusters["port"], mesh=vmesh if on_mesh else None,
                     mesh_impl="ring" if plane == "ring" else "auto")
    engine.tracer = Tracer()
    got = finish(engine.run(job))
    moved = texchange.DATA_PLANE["exchanges"] - before
    assert moved >= (shuffles if on_mesh else 0)
    assert moved == 0 or on_mesh
    planes = [e["args"]["plane"]
              for e in engine.tracer.events("exchange.select")]
    assert planes == ["device"] * len(planes)
    assert len(planes) >= (shuffles if on_mesh else 0)
    assert planes == [] or on_mesh
    assert engine.tracer.events("exchange.degrade") == []
    assert got == want_jax
    oracle = getattr(tq, f"numpy_{query}")
    assert got == oracle(*getattr(tq, f"generate_{query}")(cfg, 8, seed),
                         cfg)
    assert got[0] > 0
