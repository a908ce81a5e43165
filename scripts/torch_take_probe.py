#!/usr/bin/env python3
"""Time two library operations the port's shuffles lean on, on the card,
at the q95 fact exchange's size (8 shards x 2,699,088 rows).

    python3 scripts/torch_take_probe.py

1. The row gather ``parallel.mesh.take_rows``, the kernel
   ``ops.row_gather.row_gather`` (``ms``), beside the flat
   ``index_select`` of ``row_gather_plain`` (``index_select_ms``), by row
   width and index pattern: a random permutation; the slot-fill pattern,
   where each slot of ``q`` rows has its first third live and the rest
   padding that reads ONE fixed row (as ``exchange._slot_fill`` and
   ``_pack_by_source`` do); and the same with each pad reading a distinct
   row. Then TeraSort's 25-word rows at its local and receive sorts'
   shapes. Each case is checked byte-equal first.
2. The same at the paths' own calls: every ``take_rows`` call of one ALS
   exchange (``models.als.exchange_ratings``) and one PageRank step at
   ``chip_smoke.py``'s sizes (100M ratings of 3 words; 2**27 edges of 2
   words), captured as it runs and replayed: the kernel, the plain
   version (``plain_ms``: ``take_rows`` before the kernel) and one flat
   ``index_select`` over a ready index (``library_ms``).
3. Prefix scans over ``[8, N]`` int64: ``cumsum`` and ``cummax`` along
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

import chip_smoke  # noqa: E402
from sparkrdma_tpu_torch.models import als, pagerank  # noqa: E402
from sparkrdma_tpu_torch.ops.row_gather import (  # noqa: E402
    row_gather,
    row_gather_plain,
    vector_bytes,
)
from sparkrdma_tpu_torch.parallel import mesh as mesh_mod  # noqa: E402
from sparkrdma_tpu_torch.parallel.mesh import VirtualMesh  # noqa: E402
from sparkrdma_tpu_torch.utils.u32 import (  # noqa: E402
    rows_from_numpy,
    shards_from_numpy,
)

SHARDS = 8
ROWS = 2_699_088          # q95: 899,696 rows per shard x out_factor 3
TERASORT_ROWS = (4_000_000, 8_000_000)   # HiBench large: local, receive
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


def emit(case: dict, ms: float, moved: int, **more) -> None:
    bound = moved / HBM_BYTES_PER_S * 1e3
    print(json.dumps({**case, "ms": ms, "bytes_moved": moved,
                      "bound_ms": bound, "share": bound / ms, **more}),
          flush=True)


def gather_case(case: dict, rows: torch.Tensor, idx: torch.Tensor) -> None:
    """One row gather: the kernel checked against the flat
    ``index_select``, then both timed; bytes as ``gather.bytes`` counts
    them (each picked row read and written, 8 bytes of index)."""
    got = row_gather(rows, idx)
    if not torch.equal(got, row_gather_plain(rows, idx)):
        raise AssertionError(f"row_gather != index_select at {case}")
    del got
    row_bytes = rows[0, 0].numel() * rows.element_size()
    emit({"op": "take_rows", **case, "shape": list(rows.shape),
          "picked": idx.shape[1]},
         cuda_ms(lambda: row_gather(rows, idx)),
         idx.numel() * (2 * row_bytes + 8),
         index_select_ms=cuda_ms(lambda: row_gather_plain(rows, idx)))


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
    for width in (8, 25, 3, 2, 1):
        rows = torch.randint(-2**31, 2**31 - 1, (SHARDS, ROWS, width),
                             dtype=torch.int32, device=dev, generator=gen)
        for name, idx in patterns.items():
            gather_case({"width": width, "pattern": name}, rows, idx)
        del rows
        torch.cuda.empty_cache()
    del perm, patterns
    for n in TERASORT_ROWS:
        rows = torch.randint(-2**31, 2**31 - 1, (SHARDS, n, 25),
                             dtype=torch.int32, device=dev, generator=gen)
        idx = torch.stack([torch.randperm(n, device=dev, generator=gen)
                           for _ in range(SHARDS)])
        gather_case({"width": 25, "pattern": "permutation"}, rows, idx)
        del rows, idx
        torch.cuda.empty_cache()


def _captured(fn) -> list:
    """``fn()`` with every ``take_rows`` call's caller, rows and indices
    copied as it runs."""
    inner, calls = mesh_mod.take_rows, []

    def capture(rows, idx):
        calls.append((sys._getframe(1).f_code.co_name, rows.clone(),
                      idx.clone()))
        return inner(rows, idx)
    held = [m for m in list(sys.modules.values())
            if getattr(m, "__name__", "").startswith("sparkrdma_tpu_torch")
            and getattr(m, "take_rows", None) is inner]
    for m in held:
        m.take_rows = capture
    try:
        fn()
        torch.cuda.synchronize()
    finally:
        for m in held:
            m.take_rows = inner
    return calls


def path_cases() -> None:
    """Each ``take_rows`` call of one ALS exchange and one PageRank step
    replayed: the kernel against its plain version and a flat
    ``index_select`` over a ready index."""
    dev = torch.device("cuda")
    mesh = VirtualMesh(chip_smoke.SHARDS)
    ratings = rows_from_numpy(als.generate_ratings(
        chip_smoke.ALS_CFG, chip_smoke.SHARDS, chip_smoke.ALS_PER_DEVICE,
        seed=0), mesh)
    cfg = chip_smoke.PAGERANK_CFG
    edges, ranks, out_deg = pagerank.random_graph(cfg, chip_smoke.SHARDS)
    step = pagerank.make_pagerank_step(mesh, cfg)
    args = (rows_from_numpy(edges, mesh), shards_from_numpy(ranks, mesh),
            shards_from_numpy(out_deg, mesh))
    del edges, ranks, out_deg
    runs = {"als": lambda: als.exchange_ratings(mesh, ratings,
                                                chip_smoke.ALS_QUOTA),
            "pagerank": lambda: step(*args)}
    for path, fn in runs.items():
        fn()
        for i, (caller, rows, idx) in enumerate(_captured(fn)):
            got = row_gather(rows, idx)
            if not torch.equal(got, row_gather_plain(rows, idx)):
                raise AssertionError(f"row_gather != plain at {path} {i}")
            d, n = rows.shape[0], rows.shape[1]
            flat = (idx.to(torch.int64) + torch.arange(
                d, device=dev)[:, None] * n).reshape(-1)
            table = rows.reshape((d * n,) + rows.shape[2:])
            row_bytes = rows[0, 0].numel() * rows.element_size()
            emit({"op": "take_rows", "path": path, "call": i,
                  "caller": caller, "shape": list(rows.shape),
                  "picked": idx.shape[1], "row_bytes": row_bytes,
                  "vector_bytes": vector_bytes(row_bytes, rows.data_ptr(),
                                               got.data_ptr())},
                 cuda_ms(lambda: row_gather(rows, idx)),
                 idx.numel() * (2 * row_bytes + 8),
                 plain_ms=cuda_ms(lambda: row_gather_plain(rows, idx)),
                 library_ms=cuda_ms(lambda: table.index_select(0, flat)))
            del got, flat, table, rows, idx
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
    path_cases()
    scan_cases()
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())


if __name__ == "__main__":
    main()
