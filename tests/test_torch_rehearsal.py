"""BASELINE config #2 dress rehearsal of the port at environment scale.

The port's counterpart of ``tests/test_rehearsal.py``'s streamed TeraSort
rehearsal: a dataset many times one round's capacity, streamed through
R >= 32 bounded rounds of ``sparkrdma_tpu_torch.models.terasort.
run_terasort_streamed`` on ``VirtualMesh(8, "cpu")``, with the host's
address space capped after a warm round, so a per-round leak (a round's
padded output buffer surviving past its round, as a view kept in a run
instead of a copy would do) aborts the run instead of paging. Then the
global sort is checked exactly.

Runs in a subprocess: RLIMIT_AS must not poison the shared test process.
The size is env-tunable (``REHEARSAL_MB``, default 64: a few seconds on a
CPU host; larger hosts raise it). The cap's slack is sized so that the
view leak breaks it (checked at 32, 64 and 128 MB).
"""

import json
import os
import subprocess
import sys

import pytest

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SCRIPT = r"""
import json, os, resource, sys, time
sys.path.insert(0, {repo!r})
import numpy as np
import torch
# one intra-op thread: no worker thread maps a fresh malloc arena after
# the cap is set
torch.set_num_threads(1)
from sparkrdma_tpu_torch.models.terasort import (
    TeraSortConfig, run_terasort_streamed)
from sparkrdma_tpu_torch.parallel.mesh import VirtualMesh

D = 8
size_mb = {size_mb}
row_words = 25  # 100-byte classic TeraSort rows
rows_total = (size_mb << 20) // (4 * row_words)
# >= 32 rounds: per-round capacity is ceil(total / 32) rows over D shards
rows_per_device = -(-rows_total // (32 * D))
cfg = TeraSortConfig(rows_per_device=rows_per_device, payload_words=24,
                     out_factor=2)
rows = np.random.default_rng(7).integers(
    0, 2**32, size=(rows_total, row_words), dtype=np.uint32)
data_bytes = rows.nbytes

# One warm round BEFORE the cap: the first step maps torch's allocator
# and kernel state, which has nothing to do with the streaming path.
mesh = VirtualMesh(D, "cpu")
warm = {{}}
run_terasort_streamed(mesh, cfg, rows[: D * cfg.rows_per_device],
                      phase_times=warm)

# Cap the address space: current usage + the streaming path's legitimate
# needs (per-shard runs ~= dataset, merged output ~= dataset, two
# pipelined rounds of out_factor-sized buffers, 1/32 of the dataset
# each, the merge's temporaries) + slack. Keeping each round's run as a
# view of its padded output (out_factor x the round) costs ~1x the
# dataset more and blows the cap. The parent fixes malloc's mmap
# threshold, so every large array is its own mapping, gone when freed:
# the address space then tracks live arrays, not heap fragmentation.
with open("/proc/self/status") as f:
    vm_kb = next(int(l.split()[1]) for l in f if l.startswith("VmSize"))
headroom = int(2.6 * data_bytes) + (16 << 20)
cap = (vm_kb << 10) + headroom
resource.setrlimit(resource.RLIMIT_AS, (cap, cap))
try:
    np.zeros(headroom + (64 << 20), np.uint8)
    print("CAP-NOT-EFFECTIVE")
except MemoryError:
    pass

phases = {{}}
t0 = time.perf_counter()
merged, rounds = run_terasort_streamed(mesh, cfg, rows, phase_times=phases)
wall = time.perf_counter() - t0
assert rounds >= 32, rounds

# exact global sort: per-shard sorted, ranges non-overlapping in shard
# order, multiset of keys preserved
prev_max = -1
got = []
for d, out in enumerate(merged):
    keys = out[:, 0].astype(np.int64)
    if len(keys):
        assert (np.diff(keys) >= 0).all(), f"shard {{d}} unsorted"
        assert keys[0] >= prev_max, f"shard {{d}} overlaps previous"
        prev_max = int(keys[-1])
    got.append(keys)
got = np.concatenate(got)
assert len(got) == rows_total, (len(got), rows_total)
np.testing.assert_array_equal(np.sort(got),
                              np.sort(rows[:, 0].astype(np.int64)))

print("PHASES=" + json.dumps({{
    "data_mb": size_mb, "rounds": rounds, "wall_s": round(wall, 2),
    "stage_s": round(phases["stage_s"], 2),
    "collect_s": round(phases["collect_s"], 2),
    "merge_s": round(phases["merge_s"], 2),
    "throughput_mb_s": round(size_mb / wall, 1)}}))
print("REHEARSAL-OK")
"""


def test_streamed_terasort_gb_class_rehearsal():
    size_mb = int(os.environ.get("REHEARSAL_MB", "64"))
    script = _SCRIPT.format(repo=_REPO, size_mb=size_mb)
    env = dict(os.environ, MALLOC_MMAP_THRESHOLD_="65536")
    proc = subprocess.run([sys.executable, "-c", script],
                          capture_output=True, text=True, timeout=600,
                          env=env)
    assert proc.returncode == 0, (proc.stdout[-1000:], proc.stderr[-3000:])
    if "CAP-NOT-EFFECTIVE" in proc.stdout:
        pytest.skip("RLIMIT_AS not enforceable on this platform")
    assert "REHEARSAL-OK" in proc.stdout
    phases = json.loads(next(
        ln for ln in proc.stdout.splitlines()
        if ln.startswith("PHASES=")).split("=", 1)[1])
    # the per-phase log IS the rehearsal evidence: surface it in the
    # test report even on success
    print("\nrehearsal phases:", json.dumps(phases))
    assert phases["rounds"] >= 32
