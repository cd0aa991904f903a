"""The benchmark of ``vln_magic_tpu_torch`` on one H100: one run of one cell.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Builds the cell that ``BENCHMARK.json`` names (its configuration, traffic
and metrics; ``portbench.harness``), warms up, measures for ``--seconds``,
with ``--trace 1`` profiles a few whole units of work after the window,
checks what the window produced against the plain reference
(``benchmark/reference``), and prints one JSON line last: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device`` (``breakdown`` with
``--trace 1``) and ``checks`` (each number compared beside its limit, also
the last lines of standard error).  Exits non-zero, printing no result,
without a CUDA device, or when JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

# one process with few threads: the host's own jitter is the noise the
# bounds pay for
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ.setdefault(_var, "1")
BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
# the modules whose presence means the run touched JAX or the JAX package,
# compared by whole top-level name (the port's name begins with the
# package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "vln_magic_tpu")


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    for path in (BENCH_DIR, ROOT):
        if path not in sys.path:
            sys.path.insert(0, path)

    import torch

    from portbench.harness import Spec, execute

    spec = Spec()
    chips = spec.workload(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"run.py: {args.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    out = execute(spec, args.workload, args.seed, args.seconds,
                  bool(args.trace), "cuda", STARTED)
    bad = forbidden_modules()
    if bad:
        print(f"run.py: the run loaded {bad}", file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
