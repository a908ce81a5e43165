#!/usr/bin/env python3
"""Time the PyTorch port's ring all-to-all kernel at the main paths'
block shapes, on one CUDA card.

    python3 scripts/torch_ring_bench.py [--sweep] [--label NAME]

Imports ``sparkrdma_tpu_torch`` from the current directory, so run from
the root of another checkout (with this script's path) it times that
checkout's kernel: two versions compared in one call on one card. For
each shape, one JSON line: the wrapper's CUDA-event time (median of 7
readings of 10 back-to-back calls queued behind a device-side sleep;
cold, by rotating through copies of the blocks that touch more than
100 MB, where the blocks fit in the L2, and warm too), the host's time
per launch (100 launches, no synchronisation, median of 5 rounds; and
its parts), the library transpose's time, a plain copy of the same
bytes and the byte bound (H100 SXM, 3.35 TB/s). With ``--sweep``, and a wrapper that has the TMA
body, also each body and, where the wrapper takes the TMA body, a grid
of TMA tile sizes, stage counts and CTAs per SM. The card's
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

import torch

sys.path.insert(0, os.getcwd())

from sparkrdma_tpu_torch.ops import ring_exchange  # noqa: E402

HBM_BYTES_PER_S = 3.35e12
L2_BYTES = 50 << 20
COLD_BYTES = 100 << 20
# the block shapes the main paths launch the kernel at (chip_smoke.py):
# 16-byte-aligned blocks (the TMA body), then blocks that are no multiple
# of 16 bytes (the load/store body, chip_smoke.MISALIGNED_SHAPES and q64's)
SHAPES = ((8, 8, 335544, 25), (8, 8, 1 << 21, 3), (8, 8, 1 << 22, 2),
          (8, 8, 1 << 21, 2), (8, 8, 1 << 18, 2), (8, 8, 58982, 2),
          (8, 8, 27962, 25), (8, 8, 83886, 25), (8, 8, 69905, 10),
          (4, 4, 334406, 25), (8, 8, 3277, 1), (8, 8, 819, 3),
          (8, 8, 4095, 3), (8, 8, 4095, 5))
SWEEP = tuple((tile << 10, stages, ctas)
              for tile, stages, ctas in itertools.product(
                  (8, 16, 32, 64), (2, 3, 4, 6), (1, 2, 3, 4))
              if (tile << 10) * stages * ctas <= 224 << 10)


def cuda_ms(fn, repeats: int = 7, per_repeat: int = 10) -> float:
    """Median CUDA-event time per call of ``per_repeat`` back-to-back
    calls, in ms: device time. Each reading starts behind a device-side
    sleep twice as long as the host took to queue the calls in the
    warm-up, so the host's launch work stays off the clock."""
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
        # cycles of a 2 GHz clock: the SM clock is slower, so at least
        # as long as asked
        torch.cuda._sleep(int(max(2 * queue_s, 1e-3) * 2e9))
        start.record()
        for _ in range(per_repeat):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / per_repeat)
    return statistics.median(times)


def timed(fn, blocks: torch.Tensor) -> dict:
    """Cold CUDA-event time of ``fn(blocks)`` (``ms``), and its warm time
    where the blocks fit in the L2."""
    if blocks.nbytes > L2_BYTES:
        return {"ms": cuda_ms(lambda: fn(blocks))}
    copies = -(-COLD_BYTES // (2 * blocks.nbytes)) + 1
    inputs = [blocks.clone() for _ in range(copies)]
    outs = [None] * copies
    turn = itertools.count()

    def call():
        i = next(turn) % copies
        outs[i] = fn(inputs[i])
    return {"ms": cuda_ms(call), "warm_ms": cuda_ms(lambda: fn(blocks))}


def host_us(fn, blocks: torch.Tensor, launches: int = 100,
            rounds: int = 5) -> float:
    """Median over ``rounds`` of the host-clock time of ``launches``
    calls of ``fn(blocks)`` with no synchronisation, per call, in µs."""
    per_call = []
    for _ in range(rounds):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(launches):
            fn(blocks)
        per_call.append((time.perf_counter() - t0) / launches * 1e6)
    torch.cuda.synchronize()
    return statistics.median(per_call)


def host_breakdown(blocks: torch.Tensor) -> dict:
    """Host µs per call of the wrapper's parts: the output allocation,
    the current stream's lookup (as a Stream object and as a raw
    handle), and (where the wrapper has them) the
    pointer table with the body's choice, and the launch call itself
    (struct fill, ``ctypes`` call, C launcher) into a fixed output."""
    dev = blocks.device
    parts = {"empty_like": host_us(torch.empty_like, blocks),
             "current_stream": host_us(
                 lambda b: torch.cuda.current_stream(dev).cuda_stream,
                 blocks),
             "raw_stream": host_us(
                 lambda b: torch._C._cuda_getCurrentRawStream(
                     b.get_device()), blocks)}
    if hasattr(ring_exchange, "body_for"):
        out = torch.empty_like(blocks)
        block_bytes = blocks.shape[2] * blocks.shape[3] * 4

        def table(b):
            src, dst = ring_exchange._pointer_table(b, out)
            return ring_exchange.body_for(src, dst, block_bytes)
        parts["pointer_table_and_body"] = host_us(table, blocks)
        src, dst = ring_exchange._pointer_table(blocks, out)
        body = ring_exchange.body_for(src, dst, block_bytes)
        parts["launch"] = host_us(
            lambda b: ring_exchange._launch(b, out, body, src, dst), blocks)
        # the C launcher alone, with the struct filled and the stream
        # looked up once; and the bare ctypes call, refused before any
        # CUDA call (0 shards)
        lib = ring_exchange._library()
        bases = ring_exchange._per_thread.bases
        addr = ring_exchange.ctypes.addressof(bases)
        stream = torch._C._cuda_getCurrentRawStream(blocks.get_device())
        use_tma = int(body == "tma")
        args = (block_bytes, use_tma, ring_exchange.TMA_TILE_BYTES,
                ring_exchange.TMA_STAGES, ring_exchange.TMA_CTAS_PER_SM,
                stream)
        parts["c_launcher"] = host_us(
            lambda b: lib.ring_all_to_all_launch(addr, len(src), *args),
            blocks)
        parts["ctypes_call"] = host_us(
            lambda b: lib.ring_all_to_all_launch(addr, 0, *args), blocks)
    return parts


def body_call(body: str, **tma):
    def call(blocks):
        out = torch.empty_like(blocks)
        src, dst = ring_exchange._pointer_table(blocks, out)
        ring_exchange._launch(blocks, out, body, src, dst, **tma)
        return out
    return call


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--sweep", action="store_true")
    parser.add_argument("--label", default="")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA card: this script times the card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    has_bodies = hasattr(ring_exchange, "body_for")
    for shape in SHAPES:
        gen = torch.Generator(device="cuda").manual_seed(sum(shape))
        blocks = torch.randint(-2**31, 2**31 - 1, shape, dtype=torch.int32,
                               device="cuda", generator=gen)
        want = blocks.transpose(0, 1).contiguous()
        if not torch.equal(ring_exchange.ring_all_to_all(blocks), want):
            raise AssertionError(f"ring_all_to_all wrong at {shape}")
        bound_ms = 2 * blocks.nbytes / HBM_BYTES_PER_S * 1e3
        line = {"label": args.label, "shape": list(shape),
                "bound_ms": bound_ms, "nvidia_smi": smi,
                "kernel": timed(ring_exchange.ring_all_to_all, blocks),
                "host_us_per_launch": host_us(
                    ring_exchange.ring_all_to_all, blocks),
                "host_us_parts": host_breakdown(blocks),
                "library": timed(lambda b: b.transpose(0, 1).contiguous(),
                                 blocks),
                # the same bytes copied in place order: the card's
                # practical rate for a copy of this size
                "copy": timed(torch.clone, blocks)}
        line["share"] = bound_ms / line["kernel"]["ms"]
        if has_bodies:
            out = torch.empty_like(blocks)
            line["body"] = ring_exchange.body_for(
                *ring_exchange._pointer_table(blocks, out),
                shape[2] * shape[3] * 4)
            del out
        if args.sweep and has_bodies:
            if not torch.equal(body_call("ldst")(blocks), want):
                raise AssertionError(f"ldst body wrong at {shape}")
            line["ldst"] = timed(body_call("ldst"), blocks)
        if args.sweep and has_bodies and line["body"] == "tma":
            sweep = []
            for tile, stages, ctas in SWEEP:
                call = body_call("tma", tile_bytes=tile, stages=stages,
                                 ctas_per_sm=ctas)
                if not torch.equal(call(blocks), want):
                    raise AssertionError(
                        f"tma body wrong at {shape}, {tile, stages, ctas}")
                sweep.append({"tile_bytes": tile, "stages": stages,
                              "ctas_per_sm": ctas,
                              **timed(call, blocks)})
            line["tma_sweep"] = sorted(sweep, key=lambda r: r["ms"])
        print(json.dumps(line), flush=True)
        del blocks, want
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
