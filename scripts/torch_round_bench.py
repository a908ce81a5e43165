#!/usr/bin/env python3
"""Time the PyTorch port's round driver (``run_fused_exchange``) over
``chip_smoke.py``'s ``fused_rounds`` input, on one CUDA card.

    python3 scripts/torch_round_bench.py [--repeats N] [--label NAME]

Imports ``sparkrdma_tpu_torch`` from the current directory, so run from
the root of another checkout (with this script's path) it times that
checkout's driver: two versions compared in one call on one card, in
turns. The input is the phase's: 1 GiB of 100-byte rows from seed 0 (a
u64 key in words 0-1, destination ``key % 8``) over ``VirtualMesh(8)``,
in rounds sized from a 64 MiB device memory budget. After one warm-up
run, ``--repeats`` pipelined and as many sequential runs; one JSON line
with the card's ``nvidia-smi`` name and power limit, the rounds, each
run's wall time (host clock; the driver returns numpy arrays, so each
run ends on the host) and, per run, the host milliseconds of its
``exchange.*`` spans.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.getcwd())

from sparkrdma_tpu_torch.parallel.device_plane import (  # noqa: E402
    auto_rows_per_round, run_fused_exchange)
from sparkrdma_tpu_torch.parallel.mesh import VirtualMesh  # noqa: E402
from sparkrdma_tpu_torch.utils.trace import Tracer  # noqa: E402

SHARDS = 8
WORDS = 25                                   # 100-byte rows
ROWS = SHARDS * ((1024 << 20) // 100 // SHARDS)
BUDGET = 64 << 20
SPANS = ("exchange.round", "exchange.stage", "exchange.collect",
         "exchange.merge")


def _span_ms(tracer: Tracer) -> dict:
    return {name: sum(e["dur"] for e in tracer.events(name)) / 1e3
            for name in SPANS}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--label", default=os.path.basename(os.getcwd()))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    rng = np.random.default_rng(0)
    rows = rng.integers(0, 2**32, (ROWS, WORDS), dtype=np.uint32)
    keys = rows[:, :2].copy().view(np.uint64).reshape(-1)
    dest = (keys % SHARDS).astype(np.int32)
    mesh = VirtualMesh(SHARDS)
    kw = dict(key_words=2, out_factor=2,
              rows_per_round=auto_rows_per_round(4 * WORDS, BUDGET, 2))
    run_fused_exchange(mesh, rows, dest, **kw)       # warm-up: builds, caches
    runs = {"pipelined": [], "sequential": []}
    rounds = None
    for _ in range(args.repeats):
        for mode, pipeline in (("pipelined", True), ("sequential", False)):
            tracer = Tracer()
            t0 = time.perf_counter()
            _, rounds = run_fused_exchange(mesh, rows, dest, tracer=tracer,
                                           pipeline_rounds=pipeline, **kw)
            runs[mode].append({"wall_s": time.perf_counter() - t0,
                               "span_ms": _span_ms(tracer)})
    print(json.dumps({"label": args.label, "card": card, "rows": ROWS,
                      "rounds": rounds, **runs}))


if __name__ == "__main__":
    main()
