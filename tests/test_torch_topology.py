"""Parity of the port's two-level topology (``sparkrdma_tpu_torch.parallel.
topology``) with the JAX package's: every ``Topology`` method, the
``slice_topology`` spec parser on valid and invalid specs, detection on a
mesh of 8 shards with and without a conf, the slot view, the cross-slice
tally and shim, and the memoized slice sub-meshes."""

from types import SimpleNamespace

import jax
import numpy as np
import pytest
from jax.sharding import Mesh

from sparkrdma_tpu.parallel import topology as jtopo
from sparkrdma_tpu_torch.parallel import topology as ttopo
from sparkrdma_tpu_torch.parallel.mesh import VirtualMesh

D = 8
SHAPES = [(8,), (4, 4), (2, 6), (2, 4, 2), (1, 1, 1, 5), (3,), ()]
SPECS = ["", "  ", "1", "2", "4", "8", "3", "5,5", "0,8", "x,y", "-2",
         "2,6", "1,2,5", " 4 , 4 ", "4,4,", "16", "2.5", "8,0"]


@pytest.fixture(scope="module")
def mesh():
    return Mesh(np.array(jax.devices()[:D]), ("shuffle",))


def _fields(t):
    return t.slice_sizes, t.ici_gbps, t.dcn_gbps


def _pair(sizes, **kw):
    return ttopo.Topology(sizes, **kw), jtopo.Topology(sizes, **kw)


@pytest.mark.parametrize("sizes", SHAPES, ids=str)
def test_topology_methods_match_jax(sizes):
    t, j = _pair(sizes, ici_gbps=80.0, dcn_gbps=8.0)
    assert (t.num_slices, t.num_devices, t.is_flat) == (
        j.num_slices, j.num_devices, j.is_flat)
    for pos in range(t.num_devices + 1):
        try:
            want = j.slice_of(pos)
        except IndexError:
            with pytest.raises(IndexError):
                t.slice_of(pos)
        else:
            assert t.slice_of(pos) == want
    got = t.device_slices()
    assert got.dtype == j.device_slices().dtype
    np.testing.assert_array_equal(got, j.device_slices())
    for s in range(t.num_slices):
        assert t.slice_bounds(s) == j.slice_bounds(s)
    for num_slots in (0, 1, 3, 4, 7, 16):
        for slot in (-1, 0, 1, 2, 5, 15, 40):
            if t.num_devices == 0 and num_slots > 0:
                continue  # slice_of has no slice to answer with
            assert t.slice_of_slot(slot, num_slots) == j.slice_of_slot(
                slot, num_slots)
    for intra, inter in ((0, 0), (1 << 30, 0), (0, 1 << 30),
                         (123456789, 987654), (-5, 7)):
        assert t.link_seconds(intra, inter) == j.link_seconds(intra, inter)
    assert t.uniform_inter_fraction() == j.uniform_inter_fraction()
    assert t.refine(dcn_gbps=25.0).describe() == j.refine(
        dcn_gbps=25.0).describe()
    assert t.refine(ici_gbps=3).describe() == j.refine(ici_gbps=3).describe()
    assert t.describe() == j.describe()
    assert t.refine() == t and t.dcn_gbps == 8.0   # a copy; t untouched


@pytest.mark.parametrize("spec", SPECS, ids=repr)
@pytest.mark.parametrize("num_devices", [8, 6, 0])
def test_parse_slice_spec_matches_jax(spec, num_devices):
    assert ttopo._parse_slice_spec(spec, num_devices) == \
        jtopo._parse_slice_spec(spec, num_devices)


@pytest.mark.parametrize("spec", ["", "2", "2,6", "3", "x,y", "4,4"])
def test_detect_topology_matches_jax(mesh, spec):
    conf = SimpleNamespace(slice_topology=spec, ici_gbps=80.0,
                           dcn_gbps=None)
    vmesh = VirtualMesh(D, "cpu")
    assert _fields(ttopo.detect_topology(vmesh, conf=conf)) == _fields(
        jtopo.detect_topology(mesh, conf=conf))
    # no conf: the shards of one card are one flat slice
    assert _fields(ttopo.detect_topology(vmesh)) == _fields(
        jtopo.detect_topology(mesh))
    assert ttopo.detect_topology(vmesh).slice_sizes == (D,)
    assert _fields(ttopo.detect_topology(None)) == _fields(
        jtopo.detect_topology(None))
    assert _fields(ttopo.topology_for_slots(conf, 12)) == _fields(
        jtopo.topology_for_slots(conf, 12))
    assert _fields(ttopo.topology_for_slots(None, 5)) == _fields(
        jtopo.topology_for_slots(None, 5))


def test_auto_slice_sizes_matches_jax():
    devs = [SimpleNamespace(slice_index=s) for s in (0, 0, 1, 1, 1, 2)]
    devs += [SimpleNamespace(process_index=p) for p in (3, 3)]
    devs += [object(), object()]   # no markers: process 0
    assert ttopo._auto_slice_sizes(devs) == jtopo._auto_slice_sizes(devs)
    assert ttopo._auto_slice_sizes([]) == jtopo._auto_slice_sizes([])


def test_host_topology_counts_cuda_devices():
    import torch

    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    host = ttopo.host_topology()
    assert host.num_devices == count and host.is_flat
    sliced = ttopo.host_topology(SimpleNamespace(slice_topology="1"))
    assert sliced.num_devices == count


def test_cross_slice_tally_and_shim():
    before = ttopo.cross_slice_snapshot()
    charged = []
    ttopo.cross_slice_shim = charged.append
    try:
        ttopo.record_cross_slice(100)
        ttopo.record_cross_slice(28)
    finally:
        ttopo.cross_slice_shim = None
    after = ttopo.cross_slice_snapshot()
    assert after["moves"] - before["moves"] == 2
    assert after["bytes"] - before["bytes"] == 128
    assert charged == [100, 28]


def test_slice_mesh_memoized_sub_meshes():
    vmesh = VirtualMesh(D, "cpu")
    topo = ttopo.Topology((2, 6))
    sub = ttopo.slice_mesh(vmesh, topo, 1)
    assert sub == VirtualMesh(6, "cpu")
    assert sub is ttopo.slice_mesh(VirtualMesh(D, "cpu"), topo, 1)
    assert ttopo.slice_mesh(vmesh, topo, 0).num_shards == 2
