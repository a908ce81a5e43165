"""Parity of the port's device benches (``sparkrdma_tpu_torch.shuffle.
{device_bench,topo_bench,client_bench}``) with the JAX package's.

Each pair runs at the same arguments: the JAX bench on the conftest's
8-device CPU mesh, the port's on ``VirtualMesh(8, "cpu")`` (and the
client bench's wire-to-device probe on the CPU). Both must be
byte-identical A/Bs, and what the two count from the same seeded inputs
(staged bytes, shards, cross-slice bytes, bytes per mode) must be equal.
No wall-clock or CPU-ratio gate: those are card numbers
(``chip_smoke.py``'s ``cli_and_benches`` phase)."""

import numpy as np
import pytest

from sparkrdma_tpu.shuffle import client_bench as jclient
from sparkrdma_tpu.shuffle import device_bench as jdevice
from sparkrdma_tpu.shuffle import topo_bench as jtopo
from sparkrdma_tpu_torch.parallel.mesh import VirtualMesh
from sparkrdma_tpu_torch.shuffle import client_bench as tclient
from sparkrdma_tpu_torch.shuffle import device_bench as tdevice
from sparkrdma_tpu_torch.shuffle import topo_bench as ttopo


def test_device_bench_matches_the_reference(tmp_path):
    want = jdevice.run_device_microbench(str(tmp_path / "jax"), reps=1)
    got = tdevice.run_device_microbench(str(tmp_path / "torch"), reps=1,
                                        mesh=VirtualMesh(8, "cpu"))
    assert want["identical"] and got["identical"], (want, got)
    assert got["bytes"] == want["bytes"] == 4 * 2048 * (8 + 8)
    assert got["devices"] == want["devices"] == 8
    assert set(got) == set(want)
    assert set(got["wall_s"]) == {"host", "fused"}


def test_device_bench_canon_matches_the_reference():
    rng = np.random.default_rng(5)
    keys = rng.integers(0, 50, 300, dtype=np.uint64)  # equal keys repeat
    payload = rng.integers(0, 255, (300, 12), dtype=np.uint64).astype(
        np.uint8)
    want = jdevice._canon(keys, payload)
    np.testing.assert_array_equal(tdevice._canon(keys, payload), want)
    np.testing.assert_array_equal(
        tdevice._canon(keys[::-1].copy(), payload[::-1].copy()), want)


def test_device_bench_needs_a_card_unless_given_a_mesh(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default mesh is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdevice.run_device_microbench(str(tmp_path))
    assert not (tmp_path / "d0").exists()  # raised before any cluster


@pytest.mark.parametrize("seed", (0, 1))
def test_topo_bench_matches_the_reference(seed):
    want = jtopo.run_topo_microbench(seed=seed, reps=1)
    got = ttopo.run_topo_microbench(seed=seed, reps=1,
                                    mesh=VirtualMesh(8, "cpu"))
    assert want["identical"] and got["identical"], (want, got)
    assert got["slices"] == want["slices"] == 2
    assert got["devices"] == want["devices"] == 8
    assert got["cross_slice_bytes"] == want["cross_slice_bytes"]
    assert got["cross_slice_bytes"]["hier"] < got["cross_slice_bytes"][
        "flat"]
    assert set(got) == set(want)


def test_topo_bench_per_partition_matches_the_reference():
    rng = np.random.default_rng(2)
    per_device = [rng.integers(0, 1 << 32, (n, 3), dtype=np.uint32)
                  for n in (0, 17, 64, 5)]
    want = jtopo._per_partition(per_device, 6)
    got = ttopo._per_partition(per_device, 6)
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        np.testing.assert_array_equal(ttopo._canon(g), jtopo._canon(w))


def test_topo_bench_single_slice_mesh_reports_its_shape():
    got = ttopo.run_topo_microbench(num_slices=3,
                                    mesh=VirtualMesh(8, "cpu"))
    assert got["slices"] == 1 and got["identical"]
    assert got["cross_slice_bytes"] == {"flat": 0, "hier": 0}
    assert "cannot form 3 equal slices" in got["note"]


def test_client_bench_matches_the_reference(tmp_path):
    from sparkrdma_tpu_torch.runtime import native

    if not native.available() or not native.has_fetch_client():
        pytest.skip("the port's native fetch client is not built")
    kw = dict(file_mb=4, total_mb=8)
    want = jclient.run_client_microbench(str(tmp_path / "jax"), **kw)
    got = tclient.run_client_microbench(str(tmp_path / "torch"),
                                        device="cpu", **kw)
    assert got["identical"], got
    db = got["doorbell"]
    assert 0 < db["writevs"] < db["frames"], got
    assert got["bytes_per_mode"] == want["bytes_per_mode"] == 8 << 20
    assert set(got) == set(want)
    assert set(got["wire_to_device_ms"]) == {"python", "native"}
    assert all(v > 0 for v in got["wire_to_device_ms"].values())


def test_client_bench_schedule_matches_the_reference():
    args = (4 << 20, 256 << 10, 8, 8 << 20)
    assert tclient._schedule(*args) == jclient._schedule(*args)
    assert tclient._schedule(1000, 4096, 3, 1) == jclient._schedule(
        1000, 4096, 3, 1)


def test_client_bench_server_runs_the_port():
    assert "from sparkrdma_tpu_torch.runtime.blockserver import" in \
        tclient._SERVER
    assert "sparkrdma_tpu." not in tclient._SERVER
    assert tclient._SERVER.replace("sparkrdma_tpu_torch.",
                                   "sparkrdma_tpu.") == jclient._SERVER
