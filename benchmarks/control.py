"""Run a cell's control on the card: the job's plain reference, with one
of the configuration's guarantees broken, in the program's place.

    python benchmarks/control.py --workload <cell> --seconds 3 --seed 1 2 3

Each seed runs the cell's own set-up and load for a short window and the
usual check, which has to come out not correct; the numbers it compared
are printed for each seed. Exits 1 unless every seed failed the check.
The benchmark's own runs never run the control.
"""

from __future__ import annotations

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmarks import harness  # noqa: E402


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seconds", type=float, default=3.0)
    parser.add_argument("--seed", type=int, nargs="+", required=True)
    args = parser.parse_args(argv)
    caught = 0
    for seed in args.seed:
        result = harness.run_cell(args.workload, seed, args.seconds, False,
                                  started=time.perf_counter(), control=True)
        caught += not result["correct"]
        print(json.dumps({"control": args.workload, "seed": seed,
                          "correct": result["correct"],
                          "checks": result["checks"]}), flush=True)
    return 0 if caught == len(args.seed) else 1


if __name__ == "__main__":
    sys.exit(main())
