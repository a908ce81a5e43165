"""Card-only tests of the port: the CUDA ring all-to-all kernel against its
plain version, its argument checks, and the TeraSort step on the card
against the same step on the CPU. Marked ``cuda``; each skips with a
reason where there is no card. This file imports no JAX, so it runs on a
machine without it:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from sparkrdma_tpu_torch.ops import ring_exchange as tre

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _blocks(shape, seed, device):
    rng = np.random.default_rng(seed)
    host = rng.integers(-2**31, 2**31, size=shape, dtype=np.int64)
    return torch.from_numpy(host.astype(np.int32)).to(device)


@pytest.mark.parametrize("shape", [(1, 1, 4, 4), (2, 2, 1, 1), (3, 3, 5, 7),
                                   (8, 8, 3, 3), (8, 8, 4, 4),
                                   (8, 8, 1000, 25), (5, 5, 4099, 1)])
def test_kernel_matches_plain(cuda, shape):
    x = _blocks(shape, sum(shape), cuda)
    before = tre.LAUNCHES
    got = tre.ring_all_to_all(x)
    torch.cuda.synchronize()
    assert tre.LAUNCHES == before + 1
    assert torch.equal(got, tre.ring_all_to_all_plain(x))
    assert torch.equal(got, x.transpose(0, 1).contiguous())


def test_kernel_unaligned_base_pointer(cuda):
    """A contiguous view that starts 4 bytes into its storage: no block is
    16-byte aligned, so every word takes the scalar path."""
    shape = (4, 4, 6, 8)
    flat = _blocks((1 + int(np.prod(shape)),), 3, cuda)
    x = flat[1:].view(shape)
    assert x.is_contiguous() and x.data_ptr() % 16
    got = tre.ring_all_to_all(x)
    torch.cuda.synchronize()
    assert torch.equal(got, tre.ring_all_to_all_plain(x))


def test_kernel_refuses_bad_arguments(cuda):
    with pytest.raises(TypeError, match="int32"):
        tre.ring_all_to_all(torch.zeros((2, 2, 3, 3), device=cuda))
    with pytest.raises(ValueError, match=r"\[D, D, C, W\]"):
        tre.ring_all_to_all(torch.zeros((2, 3, 3, 3), dtype=torch.int32,
                                        device=cuda))
    with pytest.raises(ValueError, match="contiguous"):
        tre.ring_all_to_all(torch.zeros((2, 2, 3, 3), dtype=torch.int32,
                                        device=cuda).transpose(0, 1))


@pytest.mark.parametrize("impl", ["ring", "dense", "gather"])
def test_terasort_step_on_card_matches_cpu(cuda, impl):
    from sparkrdma_tpu_torch.models.terasort import (
        TeraSortConfig, generate_rows, make_terasort_step)
    from sparkrdma_tpu_torch.parallel.mesh import VirtualMesh
    from sparkrdma_tpu_torch.utils.u32 import rows_from_numpy

    cfg = TeraSortConfig(rows_per_device=4096, payload_words=24)
    rows = generate_rows(cfg, 8, seed=9)
    rows[::17, 0] = 2**32 - 1
    outs = []
    for mesh in (VirtualMesh(8, cuda), VirtualMesh(8, "cpu")):
        step = make_terasort_step(mesh, cfg, impl=impl)
        outs.append([t.cpu() for t in step(rows_from_numpy(rows, mesh))])
    for got, want in zip(*outs):
        assert torch.equal(got, want)
