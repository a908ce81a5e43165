"""Run one cell of the port's benchmark once and print its result line.

    python benchmarks/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell's files are found by name under ``benchmarks/`` (see
``harness.py``). The run needs a CUDA card: without one it exits 1. Caches
of kernel builds stay inside the checkout, under ``build/``.
"""

from __future__ import annotations

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "build" / "bench_cache"


def _fail(message: str) -> int:
    print(f"benchmark: {message}", file=sys.stderr)
    return 1


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(CACHE / sub)
    sys.path.insert(0, str(ROOT))
    workload = ROOT / "benchmarks" / "workloads" / f"{args.workload}.json"
    if not workload.is_file():
        return _fail(f"no workload named {args.workload!r}")
    chips = json.loads(workload.read_text()).get("chips", 1)

    import torch

    from benchmarks import harness

    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < chips:
        return _fail(f"needs {chips} CUDA card(s); found {cards}")
    if not (ROOT / "sparkrdma_tpu_torch").is_dir():
        return _fail("the program (sparkrdma_tpu_torch) is not in this "
                     "checkout")
    torch.set_num_threads(2)  # the host only launches: few threads
    result = harness.run_cell(args.workload, args.seed, args.seconds,
                              bool(args.trace), started=STARTED)
    loaded = harness.forbidden_modules()
    if loaded:
        return _fail("JAX or the JAX package was loaded: "
                     + ", ".join(loaded))
    for name, check in result["checks"].items():
        print(f"check {name} {check['value']} limit {check['limit']}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
