#!/usr/bin/env python3
"""Time two library operations the port's shuffles lean on, on the card,
at the q95 fact exchange's size (8 shards x 2,699,088 rows).

    python3 scripts/torch_take_probe.py

1. The row gather ``parallel.mesh.take_rows`` (one ``index_select`` over
   ``[D*N, W]`` int32 rows), by row width and index pattern: a random
   permutation; the slot-fill pattern, where each slot of ``q`` rows has
   its first third live and the rest padding that reads ONE fixed row (as
   ``exchange._slot_fill`` and ``_pack_by_source`` do); and the same with
   each pad reading a distinct row.
2. Prefix scans over ``[8, N]`` int64: ``cumsum`` and ``cummax`` along
   dim 1 (one row per shard) against ``cumsum`` over the same values
   flattened to one vector.

Each case prints one JSON line: CUDA-event milliseconds (median of 7
readings of 5 back-to-back calls, after a warm-up), the bytes it must
move (each input read once, each output written once) and the byte
bound at 3.35 TB/s. Ends with the card's name and power limit.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path.cwd()))

from sparkrdma_tpu_torch.parallel.mesh import take_rows  # noqa: E402

SHARDS = 8
ROWS = 2_699_088          # q95: 899,696 rows per shard x out_factor 3
SLOT = ROWS // SHARDS     # q = out_cap // D
HBM_BYTES_PER_S = 3.35e12


def cuda_ms(fn, repeats: int = 7, per_repeat: int = 5) -> float:
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(per_repeat):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / per_repeat)
    return statistics.median(times)


def emit(case: dict, ms: float, moved: int) -> None:
    bound = moved / HBM_BYTES_PER_S * 1e3
    print(json.dumps({**case, "ms": ms, "bytes_moved": moved,
                      "bound_ms": bound, "share": bound / ms}), flush=True)


def gather_cases() -> None:
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    pos = torch.arange(ROWS, device=dev)
    live = (pos % SLOT) < SLOT // 3
    perm = torch.stack([torch.randperm(ROWS, device=dev, generator=gen)
                        for _ in range(SHARDS)])
    patterns = {
        "permutation": perm,
        "pads_read_row0": torch.where(live, perm, 0),
        "pads_spread": torch.where(live, perm, pos),
    }
    for width in (8, 25, 3):
        rows = torch.randint(-2**31, 2**31 - 1, (SHARDS, ROWS, width),
                             dtype=torch.int32, device=dev, generator=gen)
        for name, idx in patterns.items():
            ms = cuda_ms(lambda: take_rows(rows, idx))
            emit({"op": "take_rows", "width": width, "pattern": name,
                  "shape": [SHARDS, ROWS, width]}, ms,
                 2 * rows.numel() * 4 + idx.numel() * 8)
        del rows
        torch.cuda.empty_cache()


def scan_cases() -> None:
    dev = torch.device("cuda")
    values = torch.randint(0, 1000, (SHARDS, ROWS), dtype=torch.int64,
                           device=dev)
    moved = 2 * values.numel() * 8
    emit({"op": "cumsum", "layout": "[8, N] along dim 1"},
         cuda_ms(lambda: torch.cumsum(values, dim=1)), moved)
    flat = values.reshape(-1)
    emit({"op": "cumsum", "layout": "flat [8N]"},
         cuda_ms(lambda: torch.cumsum(flat, dim=0)), moved)
    emit({"op": "cummax", "layout": "[8, N] along dim 1"},
         cuda_ms(lambda: torch.cummax(values, dim=1)), moved + moved // 2)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    gather_cases()
    scan_cases()
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())


if __name__ == "__main__":
    main()
