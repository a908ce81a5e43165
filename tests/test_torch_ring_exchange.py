"""The port's ring all-to-all (``sparkrdma_tpu_torch.ops.ring_exchange``)
against the JAX package's Pallas ring kernel, run in interpret mode on
the 8-device CPU mesh, and against the swapaxes oracle. On the CPU the
wrapper takes the plain version; the CUDA kernel itself is checked on
the card (``test_torch_cuda.py`` and ``chip_smoke.py``)."""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from sparkrdma_tpu.ops.ring_exchange import make_ring_all_to_all
from sparkrdma_tpu_torch.ops import ring_exchange as tre

D = 8


@pytest.fixture(scope="module")
def mesh():
    return Mesh(np.array(jax.devices()[:D]), ("shuffle",))


def _jax_ring(mesh, x: np.ndarray) -> np.ndarray:
    a2a = make_ring_all_to_all(mesh, "shuffle", interpret=True)
    sharding = NamedSharding(mesh, P("shuffle"))
    return np.asarray(jax.block_until_ready(a2a(jax.device_put(x, sharding))))


def _torch(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x).view(np.int32))


def _numpy(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


@pytest.mark.parametrize("c,w", [(16, 8), (3, 3), (1, 25)])
def test_plain_matches_pallas_interpret_and_swapaxes(mesh, c, w):
    x = np.random.default_rng(c * 31 + w).integers(
        0, 2**32, size=(D, D, c, w), dtype=np.uint32)
    want = _jax_ring(mesh, x)
    np.testing.assert_array_equal(want, np.swapaxes(x, 0, 1))
    got = tre.ring_all_to_all_plain(_torch(x))
    np.testing.assert_array_equal(_numpy(got), want)


def test_identity_stamps_land_on_the_right_shard(mesh):
    """Shard i's block for shard j carries the stamp i*100+j and must
    arrive as shard j's block from i, intact."""
    x = np.zeros((D, D, 4, 4), dtype=np.uint32)
    for i in range(D):
        for j in range(D):
            x[i, j] = i * 100 + j
    want = _jax_ring(mesh, x)
    got = _numpy(tre.ring_all_to_all(_torch(x)))
    np.testing.assert_array_equal(got, want)
    for j in range(D):
        for i in range(D):
            assert (got[j, i] == i * 100 + j).all(), (i, j)


def test_single_shard_is_identity():
    mesh1 = Mesh(np.array(jax.devices()[:1]), ("shuffle",))
    x = np.arange(16, dtype=np.uint32).reshape(1, 1, 4, 4)
    want = np.asarray(make_ring_all_to_all(mesh1, "shuffle", interpret=True)(
        jax.device_put(x, NamedSharding(mesh1, P("shuffle")))))
    got = _numpy(tre.ring_all_to_all(_torch(x)))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, x)


@pytest.mark.parametrize("d", [2, 3, 5])
def test_cpu_wrapper_is_the_plain_version_and_counts_nothing(d):
    """A CPU tensor takes the plain version; only a kernel launch counts."""
    x = torch.from_numpy(np.random.default_rng(d).integers(
        -2**31, 2**31, size=(d, d, 5, 7), dtype=np.int64).astype(np.int32))
    before = tre.LAUNCHES
    got = tre.ring_all_to_all(x)
    assert tre.LAUNCHES == before
    assert torch.equal(got, x.transpose(0, 1).contiguous())
    assert torch.equal(got, tre.ring_all_to_all_plain(x))


def test_wrapper_refuses_other_devices():
    """Neither a CUDA nor a CPU tensor: raise, never a silent copy."""
    x = torch.empty((2, 2, 3, 3), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        tre.ring_all_to_all(x)
