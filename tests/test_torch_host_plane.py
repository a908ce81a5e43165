"""The port's copy of the host plane against the JAX package's.

The README's ``TpuShuffleManager`` quick start runs in both packages on
the same data and reads back the same records. The port's
``TpuShuffleReader.read_to_device`` stages on the CPU the same keys and
payload as the JAX method, both through the staging gather and through
the lease-donation branch (``native_fetch`` on, every chunk landed in
pool-lease memory by the native fetch engine), and frees every lease;
its staging gather is a pool lease charged to the fetcher's tenant, so
a tenant over ``tenant_pool_quota`` is refused as in the JAX package.
The native shim is the port's own, built from ``csrc/`` into ``build/``.
"""

import subprocess
import sys

import numpy as np
import pytest
import torch

from sparkrdma_tpu.config import TpuShuffleConf as JConf
from sparkrdma_tpu.runtime import pool as jpool
from sparkrdma_tpu.shuffle import manager as jmanager
from sparkrdma_tpu.shuffle import reader as jreader
from sparkrdma_tpu.shuffle import tenancy as jtenancy
from sparkrdma_tpu_torch.config import TpuShuffleConf as TConf
from sparkrdma_tpu_torch.runtime import native as tnative
from sparkrdma_tpu_torch.runtime import pool as tpool
from sparkrdma_tpu_torch.runtime import shim_build
from sparkrdma_tpu_torch.shuffle import manager as tmanager
from sparkrdma_tpu_torch.shuffle import reader as treader
from sparkrdma_tpu_torch.shuffle import tenancy as ttenancy

PKGS = {"jax": (jmanager, jreader, JConf),
        "port": (tmanager, treader, TConf)}
CONF_KW = dict(connect_timeout_ms=5000, pre_warm_connections=False)
TENANT_ERRORS = {"jax": jtenancy.TenantQuotaError,
                 "port": ttenancy.TenantQuotaError}
MAPS, PARTS, WIDTH = 8, 8, 12


def _map_data(m: int):
    rng = np.random.default_rng(40 + m)
    keys = rng.integers(0, 2**64, 300 + 17 * m, dtype=np.uint64)
    return keys, rng.integers(0, 256, (len(keys), WIDTH), dtype=np.uint8)


@pytest.fixture(scope="module")
def clusters(tmp_path_factory):
    """Per package: a driver and 3 executors holding the same committed
    shuffle, maps 0-7 written by executors 0 and 1."""
    tmp = tmp_path_factory.mktemp("torch_host_plane")
    made = {}
    try:
        for pkg, (manager, _, conf_cls) in PKGS.items():
            conf = conf_cls(**CONF_KW)
            driver = manager.TpuShuffleManager(conf, is_driver=True)
            made[pkg] = (driver, [])
            for i in range(3):
                made[pkg][1].append(manager.TpuShuffleManager(
                    conf, driver_addr=driver.driver_addr,
                    executor_id=str(i), spill_dir=str(tmp / f"{pkg}{i}")))
            for ex in made[pkg][1]:
                ex.executor.wait_for_members(3)
            handle = driver.register_shuffle(
                0, num_maps=MAPS, num_partitions=PARTS,
                partitioner=manager.PartitionerSpec("hash"),
                row_payload_bytes=WIDTH)
            for m in range(MAPS):
                w = made[pkg][1][m % 2].get_writer(handle, map_id=m)
                w.write_batch(*_map_data(m))
                w.close()
            made[pkg] += (handle,)
        yield made
    finally:
        for driver, execs, *_ in made.values():
            for ex in execs:
                ex.stop()
            driver.stop()


def _rows(keys: np.ndarray, payload: np.ndarray) -> np.ndarray:
    """Records as sorted byte rows: order-free comparison."""
    rows = np.concatenate([np.ascontiguousarray(keys).reshape(
        len(keys), -1).view(np.uint8), np.asarray(payload)], axis=1)
    return rows[np.lexsort(rows.T[::-1])]


def test_quick_start_reads_match(clusters):
    """The README's quick start: every partition range reads back the
    same records in both packages, and they are the records written."""
    got = {}
    for pkg, (_, execs, handle) in clusters.items():
        got[pkg] = [execs[2].get_reader(handle, lo, hi).read_all()
                    for lo, hi in ((0, PARTS), (0, 4), (5, 6))]
    for (tk, tp), (jk, jp) in zip(got["port"], got["jax"]):
        assert tk.dtype == jk.dtype and tp.dtype == jp.dtype
        np.testing.assert_array_equal(_rows(tk, tp), _rows(jk, jp))
    keys, payload = (np.concatenate(c) for c in zip(
        *(_map_data(m) for m in range(MAPS))))
    np.testing.assert_array_equal(_rows(*got["port"][0]),
                                  _rows(keys, payload))


def _read_to_device(pkg, clusters, native_fetch: bool):
    manager, reader_mod, conf_cls = PKGS[pkg]
    _, execs, handle = clusters[pkg]
    conf = conf_cls(**dict(CONF_KW, native_fetch=native_fetch))
    reader = reader_mod.TpuShuffleReader(
        execs[2].executor, execs[2].resolver, conf, handle.shuffle_id,
        handle.num_maps, 0, PARTS, WIDTH, pool=execs[2].pool)
    if pkg == "jax":
        keys, payload = reader.read_to_device(execs[2].pool)
        return np.asarray(keys), np.asarray(payload)
    keys, payload = reader.read_to_device(execs[2].pool, device="cpu")
    assert keys.dtype == torch.int32 and keys.shape[1] == 2
    assert payload.dtype == torch.uint8 and payload.shape[1] == WIDTH
    return keys.numpy().view(np.uint32), payload.numpy()


@pytest.mark.parametrize("native_fetch", [True, False])
def test_reader_read_to_device_matches_jax(clusters, monkeypatch,
                                           native_fetch):
    """The port stages the JAX method's records; with ``native_fetch``
    it takes the lease-donation branch (the fetch is remote: executor 2
    holds no map), without it the staging gather, and no lease leaks."""
    if native_fetch and not tnative.has_fetch_client():
        pytest.fail("the port's shim has no native fetch client")
    taken = {"donated": 0, "gathered": 0}
    donated, gathered = treader._donated, treader._gather

    def donate_spy(*a, **kw):
        taken["donated"] += 1
        return donated(*a, **kw)

    def gather_spy(*a, **kw):
        taken["gathered"] += 1
        return gathered(*a, **kw)

    monkeypatch.setattr(treader, "_donated", donate_spy)
    monkeypatch.setattr(treader, "_gather", gather_spy)
    tk, tp = _read_to_device("port", clusters, native_fetch)
    jk, jp = _read_to_device("jax", clusters, native_fetch)
    assert taken == ({"donated": 1, "gathered": 0} if native_fetch
                     else {"donated": 0, "gathered": 1})
    assert len(tk) == sum(len(_map_data(m)[0]) for m in range(MAPS))
    np.testing.assert_array_equal(_rows(tk, tp), _rows(jk, jp))
    pool = clusters["port"][1][2].pool
    assert pool.idle_bytes == pool.total_bytes, "leaked pool lease"


@pytest.mark.parametrize("quota", [4096, 1 << 20])
def test_read_to_device_charges_the_tenant_pool_quota(clusters, quota):
    """Both packages stage the gather (``native_fetch`` off) through a
    lease of the pool given to ``read_to_device``, charged to the fetcher's tenant: under a
    quota smaller than the partition both raise ``TenantQuotaError``
    before any staging; within it both stage the same records through
    the lease. Either way the tenant's gauge is back to zero after."""
    staged = sum(len(_map_data(m)[0]) for m in range(MAPS)) * (8 + WIDTH)
    assert 4096 < staged < (1 << 20)
    got, pools = {}, {}
    for pkg, (_, reader_mod, conf_cls) in PKGS.items():
        _, execs, handle = clusters[pkg]
        pool_mod = (tpool if pkg == "port" else jpool)
        pools[pkg] = pool = pool_mod.BufferPool(
            conf_cls(tenant_pool_quota=quota))
        reader = reader_mod.TpuShuffleReader(
            execs[2].executor, execs[2].resolver,
            conf_cls(**dict(CONF_KW, native_fetch=False)),
            handle.shuffle_id, handle.num_maps, 0, PARTS, WIDTH,
            pool=execs[2].pool)
        tenant = reader.fetcher.tenant
        kw = {"device": "cpu"} if pkg == "port" else {}
        try:
            if quota < staged:
                with pytest.raises(TENANT_ERRORS[pkg]):
                    reader.read_to_device(pool, **kw)
                assert pool.peak_leased_bytes == 0
            else:
                keys, payload = reader.read_to_device(pool, **kw)
                got[pkg] = (np.asarray(keys).view(np.uint32)
                            if pkg == "jax" else
                            keys.numpy().view(np.uint32),
                            np.asarray(payload))
                assert pool.peak_leased_bytes >= staged
            assert pool.tenant_leased_bytes(tenant) == 0
            assert pool.idle_bytes == pool.total_bytes, "leaked pool lease"
        finally:
            pool.stop()
    if got:
        assert len(got["port"][0]) == staged // (8 + WIDTH)
        np.testing.assert_array_equal(_rows(*got["port"]), _rows(*got["jax"]))


def test_donated_rows_survive_the_leases(clusters):
    """The donation copies: freeing (and overwriting) the source views
    after the call leaves the staged rows intact."""
    views = [np.frombuffer(bytes(range(40)) * 3, np.uint8).copy()
             for _ in range(2)]
    keys, payload = treader._donated(views, 12, "cpu")
    want = np.concatenate(views).reshape(-1, 20)
    for v in views:
        v[:] = 0
    np.testing.assert_array_equal(keys.numpy().view(np.uint8).reshape(
        -1, 8), want[:, :8])
    np.testing.assert_array_equal(payload.numpy(), want[:, 8:])


def test_shim_is_built_from_csrc_into_build():
    """``runtime/native.py`` loads the port's own library, compiled from
    the checkout's ``csrc/*.cpp`` into ``build/`` under a digest of the
    sources and flags, never the JAX package's file."""
    assert tnative.LIB is not None
    path = shim_build.host_shim_path()
    assert str(path) == tnative._LIB_PATH and path.exists()
    assert path.parent == shim_build.BUILD_DIR
    assert path.name.startswith("libtpushuffle-")
    assert "sparkrdma_tpu/" not in tnative._LIB_PATH
    assert tnative.has_writer_scatter() and tnative.has_fetch_client()


def test_shim_build_failure_falls_back(tmp_path, monkeypatch, caplog):
    """No sources: the build logs a warning and returns a path that does
    not exist, so the loader falls back to pure Python."""
    monkeypatch.setattr(shim_build, "SHIM_CSRC", tmp_path / "csrc")
    monkeypatch.setattr(shim_build, "BUILD_DIR", tmp_path / "build")
    path = shim_build.host_shim_path()
    assert not path.exists()
    assert "host shim build failed" in caplog.text


def test_sanitized_shim_builds_and_passes_the_ubsan_harness():
    """``sanitized_shim_path("ubsan")`` builds ``csrc/*.cpp`` with
    ``csrc/Makefile``'s sanitizer flags into ``build/`` (apart from the
    uninstrumented library), and the native harness passes under it; a
    UBSan library needs no runtime preloaded."""
    path = shim_build.sanitized_shim_path("ubsan")
    assert path.exists() and path.parent == shim_build.BUILD_DIR
    assert path.name.startswith("libtpushuffle_ubsan-")
    assert path != shim_build.host_shim_path()
    assert shim_build.sanitized_shim_path("ubsan") == path  # found, kept
    proc = subprocess.run(
        [sys.executable, "-m", "sparkrdma_tpu_torch.analysis.native_harness",
         str(path)], cwd=shim_build._ROOT, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "all exercises passed" in proc.stdout
