"""Run one cell of the benchmark once:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with as many CUDA devices as the
cell asks for (``BENCHMARK.json``).  The last line of standard output is
the result (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``: each
number compared with its limit); the line before it the set-up by phase,
and for an open-loop cell an earlier line how late the generator ran.
The checks are also the last lines of standard error.  Exit codes: 0 a
result printed; 2 no CUDA device or too few; 3 JAX or the JAX package was
loaded; 4 a metric the cell reports could not be read.
"""
from __future__ import annotations

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="benchmark/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from benchmark.harness.imports import forbidden
    from benchmark.harness.spec import load_cell

    cell = load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); "
              f"available: {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    from benchmark.harness.runner import run_cell

    done = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                    torch.device("cuda", 0), T_START)
    bad = forbidden(sys.modules)
    if bad:
        print(f"loaded in this process: {', '.join(bad)}", file=sys.stderr)
        return 3
    res, extra = done["result"], done["extra"]
    if extra["missing_metrics"]:
        print(f"no reading of {', '.join(extra['missing_metrics'])}",
              file=sys.stderr)
        return 4
    if "generator" in extra:
        print("GENERATOR " + json.dumps(extra["generator"]))
        print("LOAD " + json.dumps(extra["load"]))
    print("SETUP " + json.dumps(extra["setup"]))
    for name, c in res["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
