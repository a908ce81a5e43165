#!/usr/bin/env python3
"""Time the PyTorch port's on-ramp to the card: ``TpuShuffleReader.
read_to_device`` and the module-level ``shuffle/reader.py::
read_to_device``, over one executor's committed map outputs.

    python3 scripts/torch_onramp_bench.py [--repeats N] [--label NAME]
                                          [--mb SIZE]

Imports ``sparkrdma_tpu_torch`` from the current directory, so run from
the root of another checkout (with this script's path) it times that
checkout's on-ramp: two versions compared in one call on one card, in
turns. The input is ``chip_smoke.py``'s mesh-service stage cut to one
executor: 100-byte records (u64 key + 92 payload bytes) from seed 0,
8 map outputs of ``--mb``/8 MiB each (1 GiB in all by default), hash
partitioned into 200 partitions, every map written by the one executor,
so the reader's fetch is local and both calls stage the same bytes.
``method`` is ``get_reader(handle, 0, 200).read_to_device(pool)``,
``module`` is ``read_to_device`` over the resolver's ``local_blocks``.
Each is timed once cold and ``--repeats`` times warm (host clock; each
call returns once the copy to the card has completed); the keys and
payload of the last call are checked against the records. One JSON line
with the card's ``nvidia-smi`` name and power limit, the bytes, every
time, and the pool's peak leased bytes after the method's calls.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.getcwd())

from sparkrdma_tpu_torch.config import TpuShuffleConf  # noqa: E402
from sparkrdma_tpu_torch.shuffle.manager import (  # noqa: E402
    PartitionerSpec, TpuShuffleManager)
from sparkrdma_tpu_torch.shuffle.reader import read_to_device  # noqa: E402

MAPS = 8
PARTITIONS = 200
PAYLOAD = 92
SHUFFLE_ID = 3


def _timed(fn, repeats: int) -> tuple:
    """``fn()`` once cold, then ``repeats`` times warm; returns (the last
    result, the cold seconds, the warm seconds)."""
    times = []
    for _ in range(1 + repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        times.append(time.perf_counter() - t0)
    return out, times[0], times[1:]


def _by_key(rows: np.ndarray) -> np.ndarray:
    """``key | payload`` byte rows in key order (the seed's u64 keys are
    distinct, so this is one order for any arrival order)."""
    keys = rows[:, :8].copy().view(np.uint64).reshape(-1)
    return rows[np.argsort(keys, kind="stable")]


def _check(keys, payload, want_rows: np.ndarray, name: str) -> None:
    """The staged rows are the committed records (compared in key order:
    the reader's order is its fetch order)."""
    got = np.concatenate([keys.cpu().numpy().view(np.uint8),
                          payload.cpu().numpy()], axis=1)
    if len(got) != len(want_rows):
        raise AssertionError(f"{name}: staged {len(got)} rows")
    if not np.array_equal(_by_key(got), want_rows):
        raise AssertionError(f"{name}: staged bytes differ from the records")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--label", default=os.path.basename(os.getcwd()))
    ap.add_argument("--mb", type=int, default=1024)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    map_rows = (args.mb << 20) // MAPS // (8 + PAYLOAD)
    rng = np.random.default_rng(0)
    keys = rng.integers(0, 2**64, MAPS * map_rows, dtype=np.uint64)
    payload = np.frombuffer(rng.bytes(len(keys) * PAYLOAD),
                            np.uint8).reshape(len(keys), PAYLOAD)
    want = np.concatenate([keys.view(np.uint8).reshape(-1, 8), payload],
                          axis=1)
    if len(np.unique(keys)) != len(keys):
        raise AssertionError("the seed's keys are not distinct")
    want = _by_key(want)
    conf = TpuShuffleConf(connect_timeout_ms=5000)
    with tempfile.TemporaryDirectory(prefix="onramp_") as tmp:
        driver = TpuShuffleManager(conf, is_driver=True)
        execs = []
        try:
            execs.append(TpuShuffleManager(
                conf, driver_addr=driver.driver_addr, executor_id="0",
                spill_dir=os.path.join(tmp, "e0")))
            ex = execs[0]
            ex.executor.wait_for_members(1)
            handle = driver.register_shuffle(
                SHUFFLE_ID, MAPS, PARTITIONS, PartitionerSpec("hash"),
                row_payload_bytes=PAYLOAD)
            for m in range(MAPS):
                rows = slice(m * map_rows, (m + 1) * map_rows)
                writer = ex.get_writer(handle, m)
                writer.write_batch(keys[rows], payload[rows])
                writer.close()
            staged = MAPS * map_rows * (8 + PAYLOAD)

            def method():
                return ex.get_reader(handle, 0, PARTITIONS).read_to_device(
                    ex.pool)

            chunks = [ex.resolver.local_blocks(SHUFFLE_ID, m, 0, PARTITIONS)
                      for m in range(MAPS)]

            def module():
                return read_to_device(chunks, PAYLOAD)

            result = {"label": args.label, "card": card, "bytes": staged,
                      "rows": MAPS * map_rows}
            for name, fn in (("method", method), ("module", module)):
                (k, p), cold, warm = _timed(fn, args.repeats)
                _check(k, p, want, name)
                del k, p
                result[name] = {
                    "cold_s": cold, "warm_s": warm,
                    "cold_gb_per_s": staged / cold / 1e9,
                    "warm_gb_per_s": [staged / t / 1e9 for t in warm]}
            result["pool_peak_leased_bytes"] = ex.pool.peak_leased_bytes
            result["pool_tenant_leased_after"] = ex.pool.tenant_leased_bytes(
                0)
        finally:
            for e in execs:
                e.stop()
            driver.stop()
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
