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


@pytest.mark.parametrize("num_splitters,num_partitions", [
    (7, 8),     # the JAX callers' case: one more partition than splitters
    (0, 1),
    (12, 4),    # ids past num_partitions: jnp.bincount drops them
    (4, 4)])    # keys past the last splitter get id 4, which is dropped
def test_partition_and_count(num_splitters, num_partitions):
    keys = _edge_keys()
    sample = np.random.default_rng(num_splitters).integers(
        0, 2**32, size=256, dtype=np.uint32)
    splitters = np.sort(sample)[:num_splitters]
    want_dest, want_counts = jp.partition_and_count(
        jnp.asarray(keys), jnp.asarray(splitters), num_partitions)
    dest, counts = tp.partition_and_count(_bits(keys), _bits(splitters),
                                          num_partitions)
    assert counts.dtype == torch.int32
    assert counts.shape == (num_partitions,)
    np.testing.assert_array_equal(dest.numpy(), np.asarray(want_dest))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(want_counts))
    if num_splitters >= num_partitions:
        assert int(counts.sum()) < len(keys)   # some ids were dropped
    # a [D, N] batch counts per shard, each row as the JAX function
    batch = keys[:8 * 512].reshape(8, 512)
    _, batched = tp.partition_and_count(_bits(batch), _bits(splitters),
                                        num_partitions)
    for d in range(8):
        np.testing.assert_array_equal(
            batched[d].numpy(), np.asarray(jp.partition_and_count(
                jnp.asarray(batch[d]), jnp.asarray(splitters),
                num_partitions)[1]))
