#!/usr/bin/env python3
"""Time the PyTorch port's one-card ragged all-to-all kernel (the
``native`` transport) at TeraSort's shape and a few smaller ones, on one
CUDA card.

    python3 scripts/torch_ragged_bench.py [--label NAME]

Imports ``sparkrdma_tpu_torch`` from the current directory, so run from
the root of another checkout (with this script's path) it times that
checkout's kernel: two versions compared in one call on one card (run
them in turns: parent, change, change, parent). It calls only the
public ``ragged_all_to_all`` and ``ragged_all_to_all_plain``. For each
shape ``[D, cap, W, out_cap]``, one JSON line: the kernel's CUDA-event
time (median of 7 readings of 10 back-to-back calls queued behind a
device-side sleep; cold, by rotating through copies of the inputs that
touch more than 100 MB where they fit in the L2), the host's time per
launch (100 launches, no synchronisation, median of 5 rounds), the byte
bound of the rows the counts move (H100 SXM, 3.35 TB/s) and whether the
output equals the plain version. TeraSort's shape sends every row,
evenly spread; the others take random counts from a seed. The card's
``nvidia-smi`` name and power limit come first.
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.getcwd())

from sparkrdma_tpu_torch.ops import ragged_exchange  # noqa: E402

HBM_BYTES_PER_S = 3.35e12
L2_BYTES = 50 << 20
COLD_BYTES = 100 << 20
# [D, cap, W, out_cap]: TeraSort 1 GiB over 8 shards (100-byte rows into
# twice the rows), chip_smoke.py's kernel_native sweep at W = 1 and 25,
# and the few-KB shapes of q64 and the CLI's demos
SHAPES = ((8, 1342177, 25, 2684354), (8, 1 << 17, 1, 1 << 18),
          (8, 1 << 17, 25, 1 << 18), (8, 4096, 4, 8192), (8, 100, 2, 200),
          (8, 46, 4, 92))


def cuda_ms(fn, repeats: int = 7, per_repeat: int = 10) -> float:
    """Median CUDA-event time per call of ``per_repeat`` back-to-back
    calls, in ms, each reading behind a device-side sleep twice as long as
    the host took to queue the calls in the warm-up."""
    queue_s = 0.0
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(per_repeat):
            fn()
        queue_s = max(queue_s, time.perf_counter() - t0)
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(max(2 * queue_s, 1e-3) * 2e9))
        start.record()
        for _ in range(per_repeat):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / per_repeat)
    return statistics.median(times)


def counts(d: int, cap: int, full: bool, seed: int) -> np.ndarray:
    """int32[d, d]: every row of every source, evenly spread (``full``),
    or a random number of rows between cap/2 and cap, spread at random."""
    rng = np.random.default_rng(seed)
    rows = [cap if full else int(rng.integers(cap // 2, cap + 1))
            for _ in range(d)]
    return np.stack([rng.multinomial(r, np.full(d, 1.0 / d))
                     for r in rows]).astype(np.int32)


def rows_moved(mat: np.ndarray, cap: int, out_cap: int) -> int:
    m = mat.astype(np.int64)
    start = np.cumsum(m, axis=1) - m
    land = np.cumsum(m, axis=0) - m
    return int(np.maximum(np.minimum(m, np.minimum(cap - start,
                                                   out_cap - land)),
                          0).sum())


def measure(shape, seed: int) -> dict:
    d, cap, w, out_cap = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)
    data = torch.randint(-2**31, 2**31 - 1, (d, cap, w), dtype=torch.int32,
                         device="cuda", generator=gen)
    host_mat = counts(d, cap, cap > 1 << 20, seed)
    mat = torch.from_numpy(host_mat).cuda()
    out = torch.zeros((d, out_cap, w), dtype=torch.int32, device="cuda")
    kernel = ragged_exchange.ragged_all_to_all
    got = kernel(data, mat, out.clone())
    exact = bool(torch.equal(got, ragged_exchange.ragged_all_to_all_plain(
        data, mat, torch.zeros_like(out))))
    del got
    copies = 1
    if data.nbytes + out.nbytes <= L2_BYTES:
        copies = -(-COLD_BYTES // (data.nbytes + out.nbytes)) + 1
    pairs = [(data, out)] + [(data.clone(), out.clone())
                             for _ in range(copies - 1)]
    turn = itertools.count()

    def call():
        x, o = pairs[next(turn) % copies]
        kernel(x, mat, o)

    ms = cuda_ms(call)
    per_call = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(100):
            kernel(data, mat, out)
        per_call.append((time.perf_counter() - t0) / 100 * 1e6)
    torch.cuda.synchronize()
    rows = rows_moved(host_mat, cap, out_cap)
    bound_ms = 2 * rows * w * 4 / HBM_BYTES_PER_S * 1e3
    return {"shape": list(shape), "exact": exact, "ms": ms,
            "bound_ms": bound_ms, "roofline_share": bound_ms / ms,
            "host_us_per_launch": statistics.median(per_call),
            "rows_moved": rows}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--label", default=os.path.basename(os.getcwd()))
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this bench runs on the card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(json.dumps({"label": args.label, "nvidia_smi": smi}), flush=True)
    for i, shape in enumerate(SHAPES):
        entry = measure(shape, 7 + i)
        print(json.dumps({"label": args.label, **entry}), flush=True)
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
