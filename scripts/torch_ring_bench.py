#!/usr/bin/env python3
"""Time the PyTorch port's ring all-to-all kernel at the main paths'
block shapes, on one CUDA card.

    python3 scripts/torch_ring_bench.py [--sweep] [--terasort] [--label NAME]

Imports ``sparkrdma_tpu_torch`` from the current directory, so run from
the root of another checkout (with this script's path) it times that
checkout's kernel: two versions compared in one call on one card. For
each shape, one JSON line: the wrapper's CUDA-event time (median of 7
readings of 10 back-to-back calls queued behind a device-side sleep;
cold, by rotating through copies of the blocks that touch more than
100 MB, where the blocks fit in the L2, and warm too), the host's time
per launch (100 launches, no synchronisation, median of 5 rounds; and
its parts), the library transpose's time, a plain copy of the same
bytes and the byte bound (H100 SXM, 3.35 TB/s). Against an older
checkout whose wrapper picks one of two kernel bodies per launch (its
``_launch`` takes the body's name: a bulk-copy body for blocks that are
multiples of 16 bytes, ``aligned16`` in each line, and the load/store
body for the rest), ``--sweep`` also times the load/store body forced
onto every shape (``ldst``), and the host parts are the allocation and
stream lookups only; against a one-body checkout ``--sweep`` adds
nothing. ``--terasort`` then times the 1 GiB TeraSort step over the
ring (``make_terasort_step``, rows made on the card from seed 0;
median, least and most of 20 host-synchronised steps after two
warm-ups). The card's ``nvidia-smi`` name and power limit come first.
"""

from __future__ import annotations

import argparse
import inspect
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
# the block shapes the main paths launch the kernel at in one process
# (chip_smoke.py): 16-byte-aligned blocks, from 33.5 MB down to 16 bytes,
# then blocks that are no multiple of 16 bytes
# (chip_smoke.MISALIGNED_SHAPES and q64's)
SHAPES = ((8, 8, 335544, 25), (8, 8, 1 << 21, 3), (8, 8, 1 << 22, 2),
          (8, 8, 1 << 21, 2), (8, 8, 1 << 18, 2), (8, 8, 58982, 2),
          (8, 8, 337386, 8), (8, 8, 65536, 25), (4, 4, 55924, 25),
          (8, 8, 1 << 19, 3), (8, 8, 1 << 19, 2), (8, 8, 1 << 17, 2),
          (8, 8, 25000, 5), (8, 8, 14746, 2), (8, 8, 8192, 3),
          (8, 8, 4095, 4), (8, 8, 512, 4), (8, 8, 388, 4), (8, 8, 256, 4),
          (8, 8, 256, 3), (8, 8, 100, 4), (8, 8, 46, 4), (8, 8, 2, 4),
          (8, 8, 100, 2), (8, 8, 46, 2), (8, 8, 2, 2),
          (8, 8, 27962, 25), (8, 8, 83886, 25), (8, 8, 69905, 10),
          (4, 4, 334406, 25), (8, 8, 3277, 1), (8, 8, 819, 3),
          (8, 8, 4095, 3), (8, 8, 4095, 5))
TERASORT_BYTES = 1 << 30
TERASORT_STEPS = 20


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


def two_bodies() -> bool:
    """Whether the checkout's wrapper picks one of two kernel bodies per
    launch (its ``_launch`` takes the body's name)."""
    return "body" in inspect.signature(ring_exchange._launch).parameters


def host_breakdown(blocks: torch.Tensor) -> dict:
    """Host µs per call of the wrapper's parts: the output allocation,
    the current stream's lookup (as a Stream object and as a raw
    handle), and on a one-body checkout the pointer table and the launch
    call itself (struct fill, ``ctypes`` call, C launcher) into a fixed
    output."""
    dev = blocks.device
    parts = {"empty_like": host_us(torch.empty_like, blocks),
             "current_stream": host_us(
                 lambda b: torch.cuda.current_stream(dev).cuda_stream,
                 blocks),
             "raw_stream": host_us(
                 lambda b: torch._C._cuda_getCurrentRawStream(
                     b.get_device()), blocks)}
    if two_bodies():
        return parts
    out = torch.empty_like(blocks)
    src, dst = ring_exchange._pointer_table(blocks, out)
    parts["pointer_table"] = host_us(
        lambda b: ring_exchange._pointer_table(b, out), blocks)
    parts["launch"] = host_us(
        lambda b: ring_exchange._launch(b, src, dst), blocks)
    # the C launcher alone, with the struct filled and the stream looked
    # up once; and the bare ctypes call, refused before any CUDA call (0
    # shards)
    lib = ring_exchange._library()
    addr = ring_exchange.ctypes.addressof(ring_exchange._per_thread.bases)
    args = (blocks.shape[2] * blocks.shape[3] * 4,
            torch._C._cuda_getCurrentRawStream(blocks.get_device()))
    parts["c_launcher"] = host_us(
        lambda b: lib.ring_all_to_all_launch(addr, len(src), *args), blocks)
    parts["ctypes_call"] = host_us(
        lambda b: lib.ring_all_to_all_launch(addr, 0, *args), blocks)
    return parts


def ldst_call(blocks: torch.Tensor) -> torch.Tensor:
    """The two-body wrapper with its load/store body forced."""
    out = torch.empty_like(blocks)
    src, dst = ring_exchange._pointer_table(blocks, out)
    ring_exchange._launch(blocks, out, "ldst", src, dst)
    return out


def terasort_steps() -> dict:
    """Host-clock ms of ``TERASORT_STEPS`` synchronised 1 GiB TeraSort
    steps over the ring, after two warm-ups."""
    from sparkrdma_tpu_torch.models.terasort import (TeraSortConfig,
                                                     make_terasort_step)
    from sparkrdma_tpu_torch.parallel.mesh import VirtualMesh

    shards = 8
    cfg = TeraSortConfig(rows_per_device=TERASORT_BYTES // 100 // shards)
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = torch.randint(-2**31, 2**31 - 1,
                         (shards, cfg.rows_per_device, 1 + cfg.payload_words),
                         dtype=torch.int32, device="cuda", generator=gen)
    step = make_terasort_step(VirtualMesh(shards), cfg, impl="ring")
    for _ in range(2):
        step(rows)
    torch.cuda.synchronize()
    times = []
    for _ in range(TERASORT_STEPS):
        t0 = time.perf_counter()
        _, counts, overflowed = step(rows)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        if overflowed.any().item():
            raise AssertionError("TeraSort receive buffer overflowed")
    return {"terasort_step_ms": {"median": statistics.median(times),
                                 "min": min(times), "max": max(times),
                                 "steps": TERASORT_STEPS,
                                 "data_bytes": rows.nbytes}}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--sweep", action="store_true")
    parser.add_argument("--terasort", action="store_true")
    parser.add_argument("--label", default="")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA card: this script times the card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    has_bodies = two_bodies()
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
        line["aligned16"] = shape[2] * shape[3] % 4 == 0
        if args.sweep and has_bodies:
            if not torch.equal(ldst_call(blocks), want):
                raise AssertionError(f"ldst body wrong at {shape}")
            line["ldst"] = timed(ldst_call, blocks)
        print(json.dumps(line), flush=True)
        del blocks, want
        torch.cuda.empty_cache()
    if args.terasort:
        print(json.dumps({"label": args.label, "nvidia_smi": smi,
                          **terasort_steps()}), flush=True)


if __name__ == "__main__":
    main()
