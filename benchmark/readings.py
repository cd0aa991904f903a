"""Readings for the correctness limits of one cell, on the card.

    python3 benchmark/readings.py --workload <name> --seconds <s> \
        --seeds <n> [<n> ...]

For each seed, one run of the cell as ``run.py`` makes it (a short window
at the cell's own load), whose check also judges the control: the plain
reference computed in float8 (e4m3, one scale per tensor) put in the
program's place, its own choice at each decision of the same episodes read
against the f32 reference and held to the cell's limits.  One JSON line per
seed: the program's ``correct`` and numbers, and the control's.  A cell's
limit lies between the largest program reading and the smallest control
reading, and every control run has to come out not correct.  The
benchmark's own runs never run the control.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [BENCH_DIR, os.path.dirname(BENCH_DIR)]


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args()

    import torch

    from portbench.harness import Spec, execute

    if not torch.cuda.is_available():
        sys.exit("readings.py: no CUDA device")
    spec = Spec()
    for seed in args.seeds:
        t0 = time.perf_counter()
        out = execute(spec, args.workload, seed, args.seconds, False, "cuda",
                      t0, control=True)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "correct": out["correct"], "checks": out["checks"],
                          "control": out["control"],
                          "seconds": time.perf_counter() - t0}), flush=True)
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
