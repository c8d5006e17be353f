"""The benchmark of scenelib2_torch: one run of one cell.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

run from the root of a checkout, on a machine with the cards the cell asks
for. The last line of standard output is the run's result (one JSON
object); the last lines of standard error are the numbers the comparison
with the reference compared, each beside its limit. Exits with 2, printing
no result, where CUDA or the cards the cell needs are missing, and with 3
where JAX or the JAX package was loaded.
"""

import os
import sys
import time

T_START = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    import argparse
    import json

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # one process with few threads: the host side of the port is Python
    for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[var] = "1"
    sys.path.insert(0, ROOT)
    import torch

    from perfbench import harness

    cell = harness.Cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"perfbench: {cell.name} needs {cell.chips} CUDA device(s), this machine has {n}", file=sys.stderr)
        return 2
    harness.set_caches()
    torch.set_num_threads(1)
    result, lines = harness.run(cell, args.seed, args.seconds, bool(args.trace), "cuda", T_START)
    found = harness.forbidden_modules()
    if found:
        print(f"perfbench: the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
