"""Parity of the port's fused TeraSort step (``sparkrdma_tpu_torch.models.
terasort`` over ``parallel.device_plane.make_fused_step``) with the JAX
package's, on the same numpy rows: sorted rows (padding included), counts
and overflow flags compare exactly. The JAX ring transport runs its
Pallas kernel in interpret mode on the 8-device CPU mesh."""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from sparkrdma_tpu.models import terasort as jt
from sparkrdma_tpu.parallel.device_plane import make_fused_step as jax_step
from sparkrdma_tpu_torch.models import terasort as tt
from sparkrdma_tpu_torch.parallel.device_plane import make_fused_step
from sparkrdma_tpu_torch.parallel.mesh import VirtualMesh
from sparkrdma_tpu_torch.utils.u32 import rows_from_numpy, rows_to_numpy

D = 8


@pytest.fixture(scope="module")
def mesh():
    return Mesh(np.array(jax.devices()[:D]), ("shuffle",))


@pytest.fixture(scope="module")
def vmesh():
    return VirtualMesh(D, device="cpu")


def _rows_with_ties(cfg, seed):
    """Uniform rows plus duplicate keys, the u32 maximum among them, so
    the tie order against the receive-side sentinel is pinned."""
    rows = jt.generate_rows(cfg, D, seed=seed)
    rng = np.random.default_rng(seed + 1)
    n = len(rows)
    dup = rng.choice(n, size=n // 8, replace=False)
    rows[dup, 0] = rng.choice(np.array([7, 2**31, 2**32 - 1], np.uint32),
                              size=len(dup))
    return rows


@pytest.mark.parametrize("port_impl,jax_impl", [
    ("ring", "ring_interpret"), ("dense", "dense"), ("gather", "gather")])
def test_run_terasort_matches_jax(mesh, vmesh, port_impl, jax_impl):
    cfg = jt.TeraSortConfig(rows_per_device=256, payload_words=2,
                            out_factor=2)
    rows = _rows_with_ties(cfg, seed=4)
    want, want_counts, _ = jt.run_terasort(mesh, cfg, impl=jax_impl,
                                           rows=rows)
    got, counts, dt = tt.run_terasort(
        vmesh, tt.TeraSortConfig(256, 2, 2), impl=port_impl, rows=rows)
    assert got.dtype == np.uint32 and got.shape == want.shape
    assert counts.shape == (D, D) and dt >= 0
    np.testing.assert_array_equal(counts, want_counts)
    np.testing.assert_array_equal(got, want)
    tt.verify_terasort(got, counts, rows, D)


@pytest.mark.parametrize("sort_mode", ["gather", "multisort", "colsort"])
def test_sort_modes_match_jax(mesh, vmesh, sort_mode):
    """All three names give the stable tie order, as in JAX."""
    # out_factor 4: a 128-row shard with ties needs pair-slot headroom
    cfg = jt.TeraSortConfig(rows_per_device=128, payload_words=3,
                            out_factor=4, sort_mode=sort_mode)
    rows = _rows_with_ties(cfg, seed=5)
    want, want_counts, _ = jt.run_terasort(mesh, cfg, impl="dense",
                                           rows=rows)
    got, counts, _ = tt.run_terasort(
        vmesh, tt.TeraSortConfig(128, 3, 4, sort_mode), impl="ring",
        rows=rows)
    np.testing.assert_array_equal(counts, want_counts)
    np.testing.assert_array_equal(got, want)


def test_bad_names_raise(vmesh):
    with pytest.raises(ValueError, match="unknown sort_mode"):
        make_fused_step(vmesh, 3, sort_mode="radix")
    with pytest.raises(ValueError, match="unknown partition"):
        make_fused_step(vmesh, 3, partition="hash")
    with pytest.raises(ValueError, match="single-word"):
        make_fused_step(vmesh, 3, key_words=2, partition="range")
    with pytest.raises(NotImplementedError):
        make_fused_step(vmesh, 3, impl="native")


def test_small_run_matches_numpy_terasort(vmesh):
    cfg = tt.TeraSortConfig(rows_per_device=512, payload_words=2)
    rows = _rows_with_ties(cfg, seed=6)
    out, counts, _ = tt.run_terasort(vmesh, cfg, rows=rows)
    per = out.reshape(D, -1, out.shape[-1])
    got = np.concatenate([per[d][:counts[d].sum()] for d in range(D)])
    np.testing.assert_array_equal(got, tt.numpy_terasort(rows, D))
    np.testing.assert_array_equal(got, jt.numpy_terasort(rows, D))


@pytest.mark.parametrize("key_words", [1, 2])
@pytest.mark.parametrize("port_impl,jax_impl", [
    ("ring", "ring_interpret"), ("gather", "gather")])
def test_dest_partition_matches_jax(mesh, vmesh, key_words, port_impl,
                                    jax_impl):
    cap, width = 64, 4
    rng = np.random.default_rng(10 + key_words)
    rows = rng.integers(0, 2**32, size=(D * cap, width), dtype=np.uint32)
    rows[rng.choice(D * cap, 40, replace=False), :2] = 2**32 - 1
    rows[rng.choice(D * cap, 40, replace=False), 1] = 3
    dest = rng.integers(-1, D, size=D * cap).astype(np.int32)
    step = jax_step(mesh, "shuffle", width, out_factor=4, impl=jax_impl,
                    key_words=key_words, partition="dest")
    sh = NamedSharding(mesh, P("shuffle"))
    want = [np.asarray(a) for a in jax.block_until_ready(
        step(jax.device_put(rows, sh), jax.device_put(dest, sh)))]
    tstep = make_fused_step(vmesh, width, out_factor=4, impl=port_impl,
                            key_words=key_words, partition="dest")
    out, counts, overflowed = tstep(rows_from_numpy(rows, vmesh),
                                    torch.from_numpy(dest.reshape(D, cap)))
    np.testing.assert_array_equal(rows_to_numpy(out), want[0])
    np.testing.assert_array_equal(counts.numpy(), want[1])
    np.testing.assert_array_equal(overflowed.numpy(), want[2])


@pytest.mark.parametrize("partition", ["range", "dest"])
def test_single_shard_matches_jax(partition):
    mesh1 = Mesh(np.array(jax.devices()[:1]), ("shuffle",))
    vmesh1 = VirtualMesh(1, device="cpu")
    rng = np.random.default_rng(12)
    rows = rng.integers(0, 50, size=(64, 3)).astype(np.uint32)
    dest = rng.integers(-1, 1, size=64).astype(np.int32)
    step = jax_step(mesh1, "shuffle", 3, partition=partition, impl="gather")
    args = (rows,) if partition == "range" else (rows, dest)
    want = [np.asarray(a) for a in step(*args)]
    tstep = make_fused_step(vmesh1, 3, partition=partition)
    targs = ((rows_from_numpy(rows, vmesh1),) if partition == "range" else
             (rows_from_numpy(rows, vmesh1),
              torch.from_numpy(dest.reshape(1, -1))))
    out, counts, overflowed = tstep(*targs)
    np.testing.assert_array_equal(rows_to_numpy(out), want[0])
    np.testing.assert_array_equal(counts.numpy(), want[1])
    np.testing.assert_array_equal(overflowed.numpy(), want[2])


def test_streamed_with_partial_tail_matches_jax(mesh, vmesh):
    cfg = jt.TeraSortConfig(rows_per_device=128, payload_words=2,
                            out_factor=2)
    rng = np.random.default_rng(13)
    n_rows = int(2.5 * D * cfg.rows_per_device) - 7
    rows = rng.integers(0, 2**32, size=(n_rows, 3), dtype=np.uint32)
    rows[rng.choice(n_rows, 50, replace=False), 0] = 2**32 - 1
    want, want_rounds = jt.run_terasort_streamed(mesh, cfg, rows,
                                                 impl="dense")
    got, rounds = tt.run_terasort_streamed(vmesh, tt.TeraSortConfig(128, 2),
                                           rows, impl="ring")
    assert rounds == want_rounds == 3
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(np.concatenate(got),
                                  tt.numpy_terasort(rows, D))


def test_streamed_guards(vmesh):
    rows = np.zeros((0, 3), np.uint32)
    merged, rounds = tt.run_terasort_streamed(
        vmesh, tt.TeraSortConfig(16, 2), rows)
    assert rounds == 0 and all(m.shape == (0, 3) for m in merged)
    tail = np.zeros((D * 16 + 1, 3), np.uint32)
    with pytest.raises(ValueError, match="out_factor >= 2"):
        tt.run_terasort_streamed(vmesh, tt.TeraSortConfig(16, 2, 1), tail)


def test_overflow_raises(vmesh):
    """Every key in one shard's range past its headroom: refused."""
    cfg = tt.TeraSortConfig(rows_per_device=64, payload_words=1)
    rows = tt.generate_rows(cfg, D, seed=14)
    rows[:, 0] = 5
    with pytest.raises(OverflowError, match="receive buffer overflow"):
        tt.run_terasort(vmesh, cfg, rows=rows)


def test_verify_terasort_catches_breaches(vmesh):
    cfg = tt.TeraSortConfig(rows_per_device=64, payload_words=1)
    rows = tt.generate_rows(cfg, D, seed=15)
    out, counts, _ = tt.run_terasort(vmesh, cfg, rows=rows)
    tt.verify_terasort(out, counts, rows, D)
    per = out.reshape(D, -1, 2).copy()
    per[2, [0, 1]] = per[2, [1, 0]]                 # local order broken
    with pytest.raises(AssertionError, match="not locally sorted"):
        tt.verify_terasort(per.reshape(out.shape), counts, rows, D)
    per = out.reshape(D, -1, 2).copy()
    per[3, 0, 0] = 0                                # overlaps shard 2
    with pytest.raises(AssertionError, match="overlaps"):
        tt.verify_terasort(per.reshape(out.shape), counts, rows, D)
    with pytest.raises(AssertionError, match="row count"):
        tt.verify_terasort(out, counts, rows[:-1], D)


def test_default_mesh_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        VirtualMesh(D)


def test_rows_carry_round_trip(vmesh):
    rows = np.random.default_rng(16).integers(0, 2**32, size=(D * 5, 3),
                                              dtype=np.uint32)
    t = rows_from_numpy(rows, vmesh)
    assert t.dtype == torch.int32 and t.shape == (D, 5, 3)
    np.testing.assert_array_equal(rows_to_numpy(t), rows)
    with pytest.raises(ValueError, match="do not split"):
        rows_from_numpy(rows[:-1], vmesh)
