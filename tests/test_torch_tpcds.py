"""Parity of the port's TPC-DS star join (``sparkrdma_tpu_torch.models.
tpcds``) with the JAX package's on-mesh step and numpy oracle: the
grouped counts and sums are integers and compare exactly, for every
transport, under heavy skew, and the overflow flags agree on an
under-sized ``out_factor``. The port runs on a CPU ``VirtualMesh``; the
JAX side on the conftest's 8-device CPU mesh."""

import jax
import numpy as np
import pytest
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from sparkrdma_tpu.models import tpcds as jt
from sparkrdma_tpu_torch.models import tpcds as tt
from sparkrdma_tpu_torch.parallel.mesh import VirtualMesh
from sparkrdma_tpu_torch.utils.u32 import rows_from_numpy

D = 8
CFG = tt.TpcdsConfig(fact_rows_per_device=512, dim1_size=200,
                     dim2_size=300, num_groups=64, out_factor=4)
SKEW = tt.TpcdsConfig(fact_rows_per_device=256, dim1_size=50, dim2_size=80,
                      num_groups=32, zipf_a=1.05, out_factor=8)
TIGHT = tt.TpcdsConfig(fact_rows_per_device=256, dim1_size=8, dim2_size=50,
                       num_groups=16, zipf_a=1.01, out_factor=1)
PAIRS = [("ring", "dense"), ("dense", "dense"), ("gather", "gather"),
         ("ring", "gather"), ("native", "gather")]


@pytest.fixture(scope="module")
def mesh():
    return Mesh(np.array(jax.devices()[:D]), ("shuffle",))


@pytest.fixture(scope="module")
def vmesh():
    return VirtualMesh(D, "cpu")


def _jcfg(cfg):
    return jt.TpcdsConfig(**cfg.__dict__)


def _inputs(cfg, seed):
    fact, dim1, dim2 = tt.generate_star(cfg, D, seed)
    return fact, tt.pad_to_devices(dim1, D), tt.pad_to_devices(dim2, D)


def _jax_step(mesh, cfg, impl, seed):
    step = jt.make_tpcds_step(mesh, "shuffle", _jcfg(cfg), impl)
    sh = NamedSharding(mesh, P("shuffle"))
    return [np.asarray(a) for a in step(
        *(jax.device_put(x, sh) for x in _inputs(cfg, seed)))]


def _port_step(vmesh, cfg, impl, seed):
    step = tt.make_tpcds_step(vmesh, cfg, impl)
    return [t.numpy() for t in step(
        *(rows_from_numpy(x, vmesh) for x in _inputs(cfg, seed)))]


_JAX = {}


def _jax_cached(mesh, cfg, impl, seed):
    key = (cfg, impl, seed)
    if key not in _JAX:
        _JAX[key] = _jax_step(mesh, cfg, impl, seed)
    return _JAX[key]


def _assert_same(got, want):
    for name, g, w in zip(("counts", "sums", "overflowed"), got, want):
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)


def test_generators_match_jax():
    for got, want in zip(tt.generate_star(CFG, D, 3),
                         jt.generate_star(_jcfg(CFG), D, 3)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    rows = np.arange(30, dtype=np.uint32).reshape(15, 2)
    for n in (1, 4, 8, 32):
        np.testing.assert_array_equal(tt.pad_to_devices(rows, n),
                                      jt.pad_to_devices(rows, n))
    np.testing.assert_array_equal(tt.pad_to_devices(rows[:0], D),
                                  jt.pad_to_devices(rows[:0], D))


@pytest.mark.parametrize("port_impl,jax_impl", PAIRS)
def test_step_matches_jax(mesh, vmesh, port_impl, jax_impl):
    _assert_same(_port_step(vmesh, CFG, port_impl, 3),
                 _jax_cached(mesh, CFG, jax_impl, 3))


@pytest.mark.parametrize("port_impl", ["ring", "dense", "gather"])
def test_run_tpcds_matches_oracle(vmesh, port_impl):
    counts, sums = tt.run_tpcds(vmesh, CFG, seed=3, impl=port_impl)
    want_c, want_s = jt.numpy_tpcds(*jt.generate_star(_jcfg(CFG), D, 3),
                                    CFG.num_groups)
    assert counts.dtype == sums.dtype == np.int64
    np.testing.assert_array_equal(counts, want_c)
    np.testing.assert_array_equal(sums, want_s)
    assert counts.sum() > 0, "degenerate query: nothing joined"


@pytest.mark.parametrize("port_impl,jax_impl", PAIRS)
def test_heavy_skew_still_exact(mesh, vmesh, port_impl, jax_impl):
    """zipf_a 1.05 piles most fact rows on a few keys; the headroom keeps
    every transport exact."""
    got = _port_step(vmesh, SKEW, port_impl, 11)
    _assert_same(got, _jax_cached(mesh, SKEW, jax_impl, 11))
    assert not got[2].any()
    want_c, want_s = tt.numpy_tpcds(*tt.generate_star(SKEW, D, 11),
                                    SKEW.num_groups)
    np.testing.assert_array_equal(got[0].sum(axis=0), want_c)
    np.testing.assert_array_equal(got[1].sum(axis=0), want_s)


@pytest.mark.parametrize("port_impl,jax_impl", PAIRS[:3])
def test_overflow_flag_on_insufficient_headroom(mesh, vmesh, port_impl,
                                                jax_impl):
    """out_factor 1 under heavy skew: the same shards flag in both
    packages (within one transport kind), and ``run_tpcds`` raises."""
    got = _port_step(vmesh, TIGHT, port_impl, 1)[2]
    want = _jax_cached(mesh, TIGHT, jax_impl, 1)[2]
    assert want.any()
    np.testing.assert_array_equal(got, want)
    with pytest.raises(OverflowError):
        tt.run_tpcds(vmesh, TIGHT, seed=1, impl=port_impl)


def test_numpy_tpcds_matches_jax_oracle():
    """The vectorised oracle against the JAX package's per-row loop, with
    some fact keys outside either dimension's coverage."""
    cfg = tt.TpcdsConfig(fact_rows_per_device=300, dim1_size=120,
                         dim2_size=90, num_groups=40)
    fact, dim1, dim2 = tt.generate_star(cfg, D, 21)
    fact[::5, 1] = 5000
    for got, want in zip(tt.numpy_tpcds(fact, dim1, dim2, cfg.num_groups),
                         jt.numpy_tpcds(fact, dim1, dim2, cfg.num_groups)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    empty = dim1[:0]
    for got, want in zip(tt.numpy_tpcds(fact, empty, dim2, cfg.num_groups),
                         jt.numpy_tpcds(fact, empty, dim2, cfg.num_groups)):
        np.testing.assert_array_equal(got, want)


def test_run_tpcds_takes_a_pregenerated_star(vmesh):
    star = tt.generate_star(CFG, D, 5)
    np.testing.assert_array_equal(
        np.stack(tt.run_tpcds(vmesh, CFG, star=star)),
        np.stack(tt.run_tpcds(vmesh, CFG, seed=5)))


# -- the same plan as a DAG-engine job (build_tpcds_job) -------------------

ENGINE_CFG = tt.TpcdsConfig(fact_rows_per_device=2048, dim1_size=150,
                            dim2_size=200, num_groups=48)


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

    tmp = tmp_path_factory.mktemp("torch_tpcds_engine")
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
def test_engine_job_matches_jax_and_oracle(clusters, mesh, vmesh, plane):
    """``build_tpcds_job`` on the port's engine, its five shuffles on the
    mesh (``auto``, or ``ring``, the card's transport) or on the host
    plane, equals the JAX engine's run of the JAX builder on the same
    plane, and ``numpy_tpcds``; on the mesh no shuffle degrades."""
    from sparkrdma_tpu.engine import DAGEngine as JEngine
    from sparkrdma_tpu_torch.engine import DAGEngine as TEngine
    from sparkrdma_tpu_torch.parallel import exchange as texchange
    from sparkrdma_tpu_torch.utils.trace import Tracer

    job, finish = jt.build_tpcds_job(_jcfg(ENGINE_CFG), num_maps=3,
                                     num_partitions=4, seed=5)
    on_mesh = plane != "host"
    want_jax = finish(JEngine(*clusters["jax"],
                              mesh=mesh if on_mesh else None).run(job))
    before = texchange.DATA_PLANE["exchanges"]
    job, finish = tt.build_tpcds_job(ENGINE_CFG, num_maps=3,
                                     num_partitions=4, seed=5)
    engine = TEngine(*clusters["port"], mesh=vmesh if on_mesh else None,
                     mesh_impl="ring" if plane == "ring" else "auto")
    engine.tracer = Tracer()
    counts, sums = finish(engine.run(job))
    moved = texchange.DATA_PLANE["exchanges"] - before
    assert moved >= (5 if on_mesh else 0)
    assert moved == 0 or on_mesh
    assert [e["args"]["plane"] for e in engine.tracer.events(
        "exchange.select")] == (["device"] * 5 if on_mesh else [])
    assert engine.tracer.events("exchange.degrade") == []
    for got, want in zip((counts, sums), want_jax):
        np.testing.assert_array_equal(got, want)
    star = tt.generate_star(ENGINE_CFG, 1, seed=5)
    for got, want in zip((counts, sums),
                         tt.numpy_tpcds(*star, ENGINE_CFG.num_groups)):
        np.testing.assert_array_equal(got, want)
    assert counts.sum() > 0
