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


def test_pointer_table_layout():
    """Shard i's source base is ``i * D*C*W*4`` bytes into ``blocks`` and
    its destination base as far into ``out``; the block for shard j lies
    ``j * C*W*4`` bytes past the source base."""
    import ctypes

    d, c, w = 3, 5, 7
    blocks = torch.arange(d * d * c * w, dtype=torch.int32).reshape(d, d, c, w)
    out = torch.empty_like(blocks)
    src, dst = tre._pointer_table(blocks, out)
    shard, block = d * c * w * 4, c * w * 4
    assert src == [blocks.data_ptr() + i * shard for i in range(d)]
    assert dst == [out.data_ptr() + i * shard for i in range(d)]
    for i in range(d):
        for j in range(d):
            got = ctypes.string_at(src[i] + j * block, block)
            assert got == blocks[i, j].numpy().tobytes(), (i, j)


def test_pointer_table_refuses_more_than_max_shards():
    ok = torch.zeros((tre.MAX_SHARDS,) * 2 + (1, 1), dtype=torch.int32)
    src, dst = tre._pointer_table(ok, torch.empty_like(ok))
    assert len(src) == len(dst) == tre.MAX_SHARDS
    big = torch.zeros((tre.MAX_SHARDS + 1,) * 2 + (1, 1), dtype=torch.int32)
    with pytest.raises(ValueError, match=f"at most {tre.MAX_SHARDS} shards"):
        tre._pointer_table(big, torch.empty_like(big))


def _range_launch(src, dst, src_begin, block):
    """What the kernel's range launch does with its bases: block (i, j)
    of source shard ``src_begin + i`` goes from ``src[i] + j*block`` to
    ``dst[j] + (src_begin + i)*block``."""
    import ctypes

    for i, s in enumerate(src):
        for j, d in enumerate(dst):
            ctypes.memmove(d + (src_begin + i) * block, s + j * block, block)


@pytest.mark.parametrize("dl,procs", [(1, 2), (2, 2), (3, 2), (2, 3)])
def test_peer_pointer_table_range_launches(dl, procs):
    """Each process's table (its ``Dl`` source bases, every process's
    arena shard as a destination base), driven as the kernel drives it
    over the source range ``[rank*Dl, rank*Dl + Dl)``, fills every arena
    with the plain all-to-all of the global blocks."""
    g, c, w = dl * procs, 3, 5
    rng = np.random.default_rng(g)
    glob = torch.from_numpy(rng.integers(
        -2**31, 2**31, (g, g, c, w)).astype(np.int32))
    arenas = [torch.zeros((dl, g, c, w), dtype=torch.int32)
              for _ in range(procs)]
    shard, block = g * c * w * 4, c * w * 4
    for rank in range(procs):
        mine = glob[rank * dl:(rank + 1) * dl].contiguous()
        src, dst = tre._peer_pointer_table(
            mine, [a.data_ptr() for a in arenas])
        assert src == [mine.data_ptr() + i * shard for i in range(dl)]
        assert dst == [arenas[j // dl].data_ptr() + (j % dl) * shard
                       for j in range(g)]
        _range_launch(src, dst, rank * dl, block)
    want = tre.ring_all_to_all_plain(glob)
    for rank, arena in enumerate(arenas):
        assert torch.equal(arena, want[rank * dl:(rank + 1) * dl]), rank


def test_peer_pointer_table_refusals():
    blocks = torch.zeros((2, tre.MAX_SHARDS + 2, 1, 1), dtype=torch.int32)
    with pytest.raises(ValueError, match=f"at most {tre.MAX_SHARDS} shards"):
        tre._peer_pointer_table(blocks, [0] * (tre.MAX_SHARDS // 2 + 1))
    with pytest.raises(ValueError, match="do not make 4 destinations"):
        tre._peer_pointer_table(torch.zeros((2, 4, 1, 1), dtype=torch.int32),
                                [0, 0, 0])


def test_bases_struct_matches_the_kernel_source():
    """``_Bases`` mirrors ``struct Bases`` in the CUDA source: the same
    shard limit, 2 KB, by value in the 4 KB parameter block."""
    import ctypes
    import re
    from pathlib import Path

    src = (Path(tre.__file__).resolve().parents[1] / "csrc"
           / "ring_exchange.cu").read_text()
    limit = re.search(r"constexpr int kMaxShards = (\d+);", src)
    assert limit and int(limit.group(1)) == tre.MAX_SHARDS
    assert ctypes.sizeof(tre._Bases) == 2 * 8 * tre.MAX_SHARDS <= 4096 - 64


A = 1 << 20   # a 16-byte-aligned base address


@pytest.mark.parametrize("src,dst,block_bytes,body", [
    ([A, A + 96], [A + 4096, A + 4192], 48, "tma"),
    ([A], [A + 16], 16, "tma"),
    ([A + 4, A + 100], [A + 4096, A + 4192], 48, "ldst"),   # source base
    ([A, A + 96], [A + 4096, A + 4200], 48, "ldst"),        # one dest base
    ([A, A + 40], [A + 4096, A + 4136], 20, "ldst"),        # block size
    ([A, A + 8], [A + 4096, A + 4104], 8, "ldst"),
])
def test_body_choice_follows_alignment(src, dst, block_bytes, body):
    assert tre.body_for(src, dst, block_bytes) == body


@pytest.mark.parametrize("offset,c,w,body", [
    (0, 4, 4, "tma"), (0, 8, 2, "tma"), (0, 3, 3, "ldst"),
    (1, 4, 4, "ldst"), (4, 4, 4, "tma")])
def test_body_choice_for_tensor_views(offset, c, w, body):
    """The choice for real tensors: a contiguous view ``offset`` words into
    an aligned buffer, blocks of ``c * w`` words."""
    d = 3
    flat = torch.zeros(offset + d * d * c * w + 4, dtype=torch.int32)
    pad = (-flat.data_ptr() // 4) % 4          # align the buffer's start
    flat = flat[pad:] if pad else flat
    x = flat[offset:offset + d * d * c * w].view(d, d, c, w)
    src, dst = tre._pointer_table(x, torch.empty_like(x))
    assert tre.body_for(src, dst, c * w * 4) == (
        body if torch.empty_like(x).data_ptr() % 16 == 0 else "ldst")
