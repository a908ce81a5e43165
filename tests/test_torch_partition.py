"""Parity of the port's partitioners (``sparkrdma_tpu_torch.ops.partition``)
with the JAX package's, on the same numpy input. Integer results compare
exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparkrdma_tpu.ops import partition as jp
from sparkrdma_tpu_torch.ops import partition as tp


def _bits(a: np.ndarray) -> torch.Tensor:
    """u32 numpy words as the port's int32 bit patterns."""
    return torch.from_numpy(np.ascontiguousarray(a, np.uint32).view(np.int32))


def _edge_keys() -> np.ndarray:
    rng = np.random.default_rng(0)
    near_max = (2**32 - 1) - np.arange(64, dtype=np.uint64)
    special = np.array([0, 1, 2**16 - 1, 2**16, 2**31 - 1, 2**31,
                        2**31 + 1, 0x85EBCA6B, 0xC2B2AE35], np.uint64)
    rand = rng.integers(0, 2**32, size=4096, dtype=np.uint64)
    return np.concatenate([near_max, special, rand]).astype(np.uint32)


@pytest.mark.parametrize("num_partitions", [1, 7, 8, 1000, 2**31 - 1])
def test_hash_partition_bit_for_bit(num_partitions):
    keys = _edge_keys()
    want = np.asarray(jp.hash_partition(jnp.asarray(keys), num_partitions))
    got = tp.hash_partition(_bits(keys), num_partitions)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_hash_partition_batched_shards():
    """A ``[D, N]`` batch partitions in one call, row by row as JAX."""
    keys = _edge_keys()[:8 * 512].reshape(8, 512)
    want = np.asarray(jp.hash_partition(jnp.asarray(keys), 8))
    np.testing.assert_array_equal(tp.hash_partition(_bits(keys), 8).numpy(),
                                  want)


@pytest.mark.parametrize("num_partitions", [1, 2, 3, 8, 13])
def test_uniform_splitters_match(num_partitions):
    want = np.asarray(jp.uniform_splitters(num_partitions, jnp.uint32))
    got = tp.uniform_splitters(num_partitions, device="cpu")
    assert got.dtype == torch.int64 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("num_partitions", [2, 8, 13])
def test_range_partition_uniform_splitters(num_partitions):
    keys = _edge_keys()
    splitters = jp.uniform_splitters(num_partitions, jnp.uint32)
    want = np.asarray(jp.range_partition(jnp.asarray(keys), splitters))
    got = tp.range_partition(_bits(keys),
                             tp.uniform_splitters(num_partitions, "cpu"))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_range_partition_sampled_splitters_with_duplicates():
    """Sampled splitters may repeat; keys equal to a splitter go right."""
    rng = np.random.default_rng(1)
    keys = rng.integers(0, 50, size=(8, 300)).astype(np.uint32)
    keys[0, :5] = 2**32 - 1
    sample = rng.integers(0, 50, size=64).astype(np.uint32)
    splitters = jp.sample_splitters(sample, 8)
    np.testing.assert_array_equal(tp.sample_splitters(sample, 8), splitters)
    want = np.asarray(jp.range_partition(jnp.asarray(keys),
                                         jnp.asarray(splitters)))
    got = tp.range_partition(_bits(keys), _bits(splitters))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("num_partitions,n", [(1, 10), (4, 0), (4, 3),
                                              (8, 1000)])
def test_sample_splitters_match(num_partitions, n):
    sample = np.random.default_rng(n).integers(0, 2**32, size=n,
                                               dtype=np.uint32)
    want = jp.sample_splitters(sample, num_partitions)
    got = tp.sample_splitters(sample, num_partitions)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_uniform_splitters_default_device_is_cuda(monkeypatch):
    """No device asked for and no card: the port raises, it never runs
    on the CPU silently."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tp.uniform_splitters(8)
