"""Run one cell of the benchmark of ``tinyslam_tpu_torch`` once, on the
NVIDIA GPU of this machine, and print its result as the last line of
standard output (one JSON object)::

    python3 slambench/run.py --workload mh01_fleet8 --seed 7 --seconds 30 --trace 0

``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1`` its
per-layer ones (CUDA events over the window, then a short profiled
stretch after it).  Every run ends with the comparison
(``slambench/check.py``): against the generator's ground truth, and
against the plain reference under ``slambench/reference/``; the numbers compared,
each beside its limit, are the last lines of standard error and the last
key (``compared``) of the result; a number the workload states no limit
for comes before them, as ``observed``.  ``--control tf32`` puts the reference,
computed with TF32 matrix products, in the program's place (the check of
the comparison itself; the benchmark's own runs do not use it).

Exits with a nonzero code and prints no result where no CUDA device is
present, or where JAX or the JAX package was loaded.  The process runs
PyTorch's and numpy's CPU work on one thread, which keeps its runs
steady.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parent.parent
sys.path[0] = str(CHECKOUT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", choices=("tf32",))
    args = ap.parse_args(argv)

    # One host thread for PyTorch's and numpy's CPU work: on an NVIDIA H100
    # 80GB HBM3 host of 8 cores, four processes of one seed spread over 15%
    # in tracked frames/s with a thread a core, and over under 3% with one.
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
    from slambench import harness

    harness.pin_caches()
    import torch

    torch.set_num_threads(1)

    if not torch.cuda.is_available() or torch.cuda.device_count() < 1:
        print("slambench: no CUDA device; the benchmark runs on the card only",
              file=sys.stderr)
        return 2
    result = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                              device="cuda", control=args.control)
    found = harness.forbidden_modules()
    if found:
        print(f"slambench: forbidden modules loaded: {', '.join(found)}", file=sys.stderr)
        return 3
    for name, value in result["observed"].items():
        print(f"observed {name} {value!r} (no limit)", file=sys.stderr)
    for name, c in result["compared"].items():
        print(f"compared {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
