"""The two readings a correctness limit is set from, for one cell, on many
seeds in one process (imports, CUDA context and kernels paid once):

    python3 benchmark/tools/readings.py --workload <cell> --seconds <s> \
        --out <file.jsonl> <seed> ...

For each seed a whole run of the cell at its own load and sizes with a
short window, its comparison as ``benchmark/run.py`` makes it (the lower
reading: the program against the reference), and the control's reading:
the reference computed one precision lower (the configuration's
``control_w_bits``) in the program's place, on the same sampled images.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--out", required=True)
    p.add_argument("--rates", default=None,
                   help="comma-separated offered rates of an open-loop "
                        "cell, each in place of its traffic file's (the "
                        "knee sweep)")
    p.add_argument("--no-control", action="store_true")
    p.add_argument("seeds", nargs="+", type=int)
    args = p.parse_args(argv)
    import torch

    from benchmark.harness.runner import run_cell
    from benchmark.harness.spec import load_cell

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    rates = ([float(r) for r in args.rates.split(",")] if args.rates
             else [None])
    for rate, seed in ((r, s) for r in rates for s in args.seeds):
        cell = load_cell(args.workload)
        if rate is not None:
            cell.traffic["rate_per_s"] = rate
        t0 = time.monotonic()
        done = run_cell(cell, seed, args.seconds, False,
                        torch.device("cuda", 0), time.monotonic(),
                        control=not args.no_control)
        res, extra = done["result"], done["extra"]
        rec = {"workload": args.workload, "seed": seed,
               "seconds": args.seconds, "rate": rate,
               "wall_s": time.monotonic() - t0, "correct": res["correct"],
               "checks": res["checks"], "metrics": res["metrics"],
               "control": extra.get("control"), "load": extra.get("load"),
               "generator": extra.get("generator"),
               "device": res["device"]}
        with open(args.out, "a") as f:
            f.write(json.dumps(rec) + "\n")
        print(json.dumps({k: rec[k] for k in ("seed", "rate", "correct",
                                              "control", "load")}
                         | {"lower": res["checks"]["logits_rel_l2_max"]
                            ["value"],
                            "metrics": {k: round(v["value"], 3) for k, v in
                                        res["metrics"].items()}}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
