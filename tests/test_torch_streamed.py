"""Parity of the port's streamed TeraSort (``sparkrdma_tpu_torch.models.
terasort.run_terasort_streamed``) with the JAX package's at both
``pipeline_rounds`` settings: the same seeded numpy rows, with a partial
tail round, go through the JAX function on the 8-device CPU mesh
(``impl="dense"``) and the port's on ``VirtualMesh(8, "cpu")``; the
merged shards are byte-equal across the packages and the settings, and
``phase_times`` carries the same keys in both."""

import jax
import numpy as np
import pytest
from jax.sharding import Mesh

from sparkrdma_tpu.models import terasort as jt
from sparkrdma_tpu_torch.models import terasort as tt
from sparkrdma_tpu_torch.parallel.mesh import VirtualMesh

D = 8
ROWS_PER_DEVICE = 96
PHASE_KEYS = {"stage_s", "collect_s", "merge_s", "rounds"}


@pytest.fixture(scope="module")
def rows():
    rng = np.random.default_rng(21)
    n_rows = int(3.5 * D * ROWS_PER_DEVICE) - 5   # 4 rounds, tail padded
    rows = rng.integers(0, 2**32, size=(n_rows, 3), dtype=np.uint32)
    rows[rng.choice(n_rows, 40, replace=False), 0] = 2**32 - 1
    rows[rng.choice(n_rows, 40, replace=False), 0] = 12345
    return rows


@pytest.fixture(scope="module")
def jax_runs(rows):
    mesh = Mesh(np.array(jax.devices()[:D]), ("shuffle",))
    cfg = jt.TeraSortConfig(rows_per_device=ROWS_PER_DEVICE,
                            payload_words=2, out_factor=2)
    runs = {}
    for pipelined in (True, False):
        times = {}
        merged, rounds = jt.run_terasort_streamed(
            mesh, cfg, rows, impl="dense", pipeline_rounds=pipelined,
            phase_times=times)
        runs[pipelined] = (merged, rounds, times)
    return runs


@pytest.mark.parametrize("pipelined", [True, False])
def test_streamed_matches_jax_at_both_settings(rows, jax_runs, pipelined):
    times = {}
    got, rounds = tt.run_terasort_streamed(
        VirtualMesh(D, "cpu"), tt.TeraSortConfig(ROWS_PER_DEVICE, 2),
        rows, impl="ring", pipeline_rounds=pipelined, phase_times=times)
    for want, want_rounds, want_times in jax_runs.values():
        assert rounds == want_rounds == 4
        assert len(got) == len(want) == D
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
        assert set(times) == set(want_times) == PHASE_KEYS
    assert times["rounds"] == 4
    assert all(times[k] >= 0 for k in PHASE_KEYS)
    np.testing.assert_array_equal(np.concatenate(got),
                                  tt.numpy_terasort(rows, D))


def test_unpipelined_collects_each_round_before_the_next(rows,
                                                         monkeypatch):
    """With ``pipeline_rounds=False`` no round is dispatched while an
    earlier one is uncollected; pipelined, one round is."""
    events = []
    real = tt.make_terasort_step

    def spy_step(*a, **kw):
        step = real(*a, **kw)

        def dispatch(rows_d):
            events.append("dispatch")
            out, counts, overflowed = step(rows_d)
            return out, _Collected(counts, events), overflowed
        return dispatch

    monkeypatch.setattr(tt, "make_terasort_step", spy_step)
    for pipelined, most in ((False, 1), (True, 2)):
        events.clear()
        tt.run_terasort_streamed(VirtualMesh(D, "cpu"),
                                 tt.TeraSortConfig(ROWS_PER_DEVICE, 2), rows,
                                 pipeline_rounds=pipelined)
        live = peak = 0
        for e in events:
            live += 1 if e == "dispatch" else -1
            peak = max(peak, live)
        assert events.count("dispatch") == events.count("collect") == 4
        assert peak == most, (pipelined, events)


class _Collected:
    """A counts tensor that records when the round driver reads it."""

    def __init__(self, counts, events):
        self._counts, self._events = counts, events

    def cpu(self):
        self._events.append("collect")
        return self._counts.cpu()


def test_empty_input_leaves_phase_times_as_jax_does():
    """No rows: no round runs and neither package fills the dict."""
    empty = np.zeros((0, 3), np.uint32)
    jtimes, ttimes = {}, {}
    _, jrounds = jt.run_terasort_streamed(
        Mesh(np.array(jax.devices()[:D]), ("shuffle",)),
        jt.TeraSortConfig(ROWS_PER_DEVICE, 2), empty, impl="dense",
        pipeline_rounds=False, phase_times=jtimes)
    merged, rounds = tt.run_terasort_streamed(
        VirtualMesh(D, "cpu"), tt.TeraSortConfig(ROWS_PER_DEVICE, 2), empty,
        pipeline_rounds=False, phase_times=ttimes)
    assert rounds == jrounds == 0 and jtimes == ttimes == {}
    assert all(m.shape == (0, 3) for m in merged)
