#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``sparkrdma_tpu_torch``).

    python3 chip_smoke.py

Needs one CUDA card and ``nvcc``; builds the port's kernels from the
sources in this checkout into ``build/`` on first use. Phases, each
printing one JSON line; any failure raises and the exit code is not 0:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: every kernel of the main path, one ``nvcc`` per source;
3. kernel: ``ring_all_to_all`` against its plain PyTorch version, bit
   for bit, at the main path's shape and at an odd shape whose blocks are
   not 16-byte aligned; CUDA-event medians of the kernel, the plain
   version and one library call computing the same function;
4. main path: TeraSort of 1 GiB of 100-byte rows over an 8-shard virtual
   mesh with the ring transport (BASELINE.md config #1), counting kernel
   launches, then ``verify_terasort``; repeated warm steps timed on the
   host clock and one traced step (device time per layer span, top
   kernels, idle share); a small run held bit for bit to
   ``numpy_terasort``; a streamed run of 3 rounds with a partial tail;
5. the kernel table line, then the device line last.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import time

import numpy as np
import torch

from sparkrdma_tpu_torch.models.terasort import (
    TeraSortConfig,
    generate_rows,
    make_terasort_step,
    numpy_terasort,
    run_terasort,
    run_terasort_streamed,
    verify_terasort,
)
from sparkrdma_tpu_torch.ops import _build, ring_exchange
from sparkrdma_tpu_torch.parallel.mesh import VirtualMesh
from sparkrdma_tpu_torch.utils.u32 import rows_from_numpy

SHARDS = 8
DATA_BYTES = 1024 << 20      # BASELINE.md config #1, bench.py's default
HBM_BYTES_PER_S = 3.35e12    # H100 SXM device memory rate
KERNELS = ("ring_exchange",)
STEP_SAMPLES = 20             # untraced steps timed before the traced one


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, repeats: int = 7, per_repeat: int = 10,
            warmup: int = 3) -> float:
    """Median over ``repeats`` of the CUDA-event time of ``per_repeat``
    back-to-back calls of ``fn``, per call, in milliseconds. Queuing the
    calls back to back keeps the host's launch work off the clock."""
    for _ in range(warmup):
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


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py runs on the card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})
    return smi


def phase_build() -> None:
    t0 = time.perf_counter()
    built = _build.build(KERNELS)
    ptxas = {name: [line for line in r["log"].splitlines()
                    if "registers" in line or "spill" in line]
             for name, r in built.items()}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "per_kernel_seconds": {k: r["seconds"] for k, r in built.items()},
          "ptxas": ptxas})


def _random_blocks(shape, seed: int) -> torch.Tensor:
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randint(-2**31, 2**31 - 1, shape, dtype=torch.int32,
                         device="cuda", generator=gen)


def _max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max().item())


def phase_kernel(cfg: TeraSortConfig) -> dict:
    """The ring kernel against its plain version at the main path's
    block shape (q = out_cap // D rows of 1+P words) and an odd one."""
    q = cfg.rows_per_device * cfg.out_factor // SHARDS
    main_shape = (SHARDS, SHARDS, q, 1 + cfg.payload_words)
    errs = {}
    for shape, seed in ((main_shape, 0), ((SHARDS, SHARDS, 3, 3), 1),
                        ((3, 3, 5, 7), 2)):
        blocks = _random_blocks(shape, seed)
        got = ring_exchange.ring_all_to_all(blocks)
        plain = ring_exchange.ring_all_to_all_plain(blocks)
        torch.cuda.synchronize()
        errs[str(shape)] = _max_abs_err(got, plain)
        if not torch.equal(got, plain):
            raise AssertionError(f"ring_all_to_all != plain at {shape}")
        del got, plain
    blocks = _random_blocks(main_shape, 0)
    ms = cuda_ms(lambda: ring_exchange.ring_all_to_all(blocks))
    plain_ms = cuda_ms(lambda: ring_exchange.ring_all_to_all_plain(blocks))
    library_ms = cuda_ms(lambda: blocks.transpose(0, 1).contiguous())
    moved = 2 * blocks.numel() * blocks.element_size()  # read + write
    bound_ms = moved / HBM_BYTES_PER_S * 1e3
    # one row fewer per slot: C*W is odd, no block is 16-byte aligned and
    # the kernel takes its scalar path at full size
    odd = blocks[:, :, 1:].contiguous()
    del blocks
    got = ring_exchange.ring_all_to_all(odd)
    plain = ring_exchange.ring_all_to_all_plain(odd)
    errs[str(tuple(odd.shape))] = _max_abs_err(got, plain)
    if not torch.equal(got, plain):
        raise AssertionError(f"ring_all_to_all != plain at {odd.shape}")
    del got, plain
    unaligned_ms = cuda_ms(lambda: ring_exchange.ring_all_to_all(odd))
    del odd
    torch.cuda.empty_cache()
    row = {"name": "ring_all_to_all", "route": "cuda",
           "source": "sparkrdma_tpu_torch/csrc/ring_exchange.cu",
           "replaces": "sparkrdma_tpu/ops/ring_exchange.py:49",
           "launches": 0, "max_abs_err": max(errs.values()), "ms": ms,
           "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": "bytes",
           "library_ms": library_ms}
    emit({"phase": "kernel", "shape": list(main_shape), "bytes_moved": moved,
          "max_abs_err_by_shape": errs, "ms": ms, "plain_ms": plain_ms,
          "library_ms": library_ms, "bound_ms": bound_ms,
          "roofline_share": bound_ms / ms,
          "unaligned_shape": [SHARDS, SHARDS, q - 1, 1 + cfg.payload_words],
          "unaligned_ms": unaligned_ms})
    return row


def phase_profile(mesh: VirtualMesh, cfg: TeraSortConfig,
                  rows: np.ndarray) -> None:
    """``STEP_SAMPLES`` warm, untraced TeraSort steps timed on the host
    clock, then one step under ``torch.profiler``: device time per layer
    span (``fused.*``, ``exchange.*``), the top kernels, and the device's
    idle share of the step's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    step = make_terasort_step(mesh, cfg, impl="ring")
    rows_d = rows_from_numpy(rows, mesh)
    step(rows_d)
    torch.cuda.synchronize()
    samples = []
    for _ in range(STEP_SAMPLES):
        t0 = time.perf_counter()
        step(rows_d)
        torch.cuda.synchronize()
        samples.append((time.perf_counter() - t0) * 1e3)
    samples.sort()
    emit({"phase": "step_times", "samples": len(samples),
          "median_ms": statistics.median(samples), "min_ms": samples[0],
          "max_ms": samples[-1],
          "median_gb_per_s": rows.nbytes / statistics.median(samples) / 1e6})
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(rows_d)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans, kernels = {}, []
    for evt in prof.key_averages():
        if evt.key.startswith(("fused.", "exchange.")):
            spans[evt.key] = {"device_ms": evt.device_time_total / 1e3,
                              "host_ms": evt.cpu_time_total / 1e3}
        elif evt.device_type == DeviceType.CUDA:
            kernels.append((evt.self_device_time_total / 1e3, evt.count,
                            evt.key[:120]))
    kernels.sort(reverse=True)
    busy_ms = sum(k[0] for k in kernels)
    emit({"phase": "profile", "wall_ms": wall_ms, "device_busy_ms": busy_ms,
          "idle_share": 1 - busy_ms / wall_ms if wall_ms else None,
          "spans": spans,
          "top_kernels": [{"ms": ms, "count": c, "name": name}
                          for ms, c, name in kernels[:12]]})


def phase_main_path(cfg: TeraSortConfig) -> int:
    mesh = VirtualMesh(SHARDS)
    rows = generate_rows(cfg, SHARDS, seed=0)
    torch.cuda.reset_peak_memory_stats()
    ring_exchange.LAUNCHES = 0
    out, counts, dt = run_terasort(mesh, cfg, impl="ring", rows=rows)
    launches = ring_exchange.LAUNCHES
    if launches == 0:
        raise AssertionError("the main path never launched ring_all_to_all")
    peak = torch.cuda.max_memory_allocated()
    verify_terasort(out, counts, rows, SHARDS)
    emit({"phase": "main_path", "shards": SHARDS,
          "rows_per_device": cfg.rows_per_device,
          "row_bytes": cfg.row_bytes, "data_bytes": int(rows.nbytes),
          "step_s": dt, "gb_per_s": rows.nbytes / dt / 1e9,
          "ring_launches": launches, "peak_device_bytes": peak,
          "verified": True})
    del out
    phase_profile(mesh, cfg, rows)
    del rows

    small = TeraSortConfig(rows_per_device=4096)
    rows = generate_rows(small, SHARDS, seed=1)
    out, counts, _ = run_terasort(mesh, small, impl="ring", rows=rows)
    per = out.reshape(SHARDS, -1, out.shape[-1])
    got = np.concatenate([per[d][:int(counts[d].sum())]
                          for d in range(SHARDS)])
    np.testing.assert_array_equal(got, numpy_terasort(rows, SHARDS))

    streamed = TeraSortConfig(rows_per_device=65536)
    n_rows = int(2.5 * SHARDS * streamed.rows_per_device)
    rows = generate_rows(TeraSortConfig(rows_per_device=n_rows // SHARDS),
                         SHARDS, seed=2)[:n_rows - 13]
    merged, rounds = run_terasort_streamed(mesh, streamed, rows, impl="ring")
    if rounds != 3:
        raise AssertionError(f"expected 3 streamed rounds, ran {rounds}")
    np.testing.assert_array_equal(np.concatenate(merged),
                                  numpy_terasort(rows, SHARDS))
    emit({"phase": "checks", "small_bit_exact": True,
          "streamed_rounds": rounds, "streamed_bit_exact": True})
    return launches


def main() -> None:
    phase_device()
    phase_build()
    cfg = TeraSortConfig(rows_per_device=DATA_BYTES // 100 // SHARDS)
    row = phase_kernel(cfg)
    row["launches"] = phase_main_path(cfg)
    emit({"kernels": [row]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
