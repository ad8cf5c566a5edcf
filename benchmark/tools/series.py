"""Run cells of the benchmark one after another, each in its own process,
and keep what each printed:

    python3 benchmark/tools/series.py --out <file.jsonl> \
        <workload>:<seed>:<seconds>:<trace> ...

One JSON line a run goes to ``--out`` (its exit code, wall seconds, the
result line, the set-up and generator lines, and the end of standard
error when it failed); a short summary goes to standard output.  Runs
never overlap: one process uses the card at a time.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def one(workload: str, seed: int, seconds: float, trace: int,
        timeout: float) -> dict:
    cmd = [sys.executable, "benchmark/run.py", "--workload", workload,
           "--seed", str(seed), "--seconds", str(seconds),
           "--trace", str(trace)]
    t0 = time.monotonic()
    try:
        p = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                           timeout=timeout)
        rc, out, err = p.returncode, p.stdout, p.stderr
    except subprocess.TimeoutExpired as e:
        rc, out, err = 124, e.stdout or "", e.stderr or ""
        out = out.decode() if isinstance(out, bytes) else out
        err = err.decode() if isinstance(err, bytes) else err
    rec = {"workload": workload, "seed": seed, "seconds": seconds,
           "trace": trace, "rc": rc, "wall_s": time.monotonic() - t0}
    lines = out.strip().splitlines()
    for ln in lines:
        if ln.startswith("SETUP "):
            rec["setup"] = json.loads(ln[6:])
        elif ln.startswith("GENERATOR "):
            rec["generator"] = json.loads(ln[10:])
        elif ln.startswith("LOAD "):
            rec["load"] = json.loads(ln[5:])
    if rc == 0 and lines:
        rec["result"] = json.loads(lines[-1])
    else:
        rec["stdout_tail"] = out[-3000:]
        rec["stderr_tail"] = err[-6000:]
    return rec


def summary(rec: dict) -> str:
    r = rec.get("result")
    if r is None:
        return (f"{rec['workload']} seed={rec['seed']} rc={rec['rc']} "
                f"FAILED: {rec.get('stderr_tail', '')[-1500:]}")
    m = {k: round(v["value"], 4) for k, v in r["metrics"].items()}
    c = {k: v["value"] for k, v in r["checks"].items()}
    dev = {k: r["device"][k] for k in ("memory_peak_bytes", "busy_s",
                                       "window_s") if k in r["device"]}
    return (f"{rec['workload']} seed={rec['seed']} trace={rec['trace']} "
            f"rc={rec['rc']} wall={rec['wall_s']:.1f} correct={r['correct']}"
            f" att={r['attempted']} fail={r['failed']} {m} {c} {dev} "
            f"setup={ {k: round(v, 2) for k, v in rec['setup'].items()} }"
            + (f" load={rec['load']}" if "load" in rec else "")
            + (f" gen={rec['generator']}" if "generator" in rec else ""))


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--out", required=True)
    p.add_argument("--timeout", type=float, default=1300)
    p.add_argument("runs", nargs="+")
    args = p.parse_args(argv)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    for spec in args.runs:
        w, seed, sec, tr = spec.split(":")
        rec = one(w, int(seed), float(sec), int(tr), args.timeout)
        with open(args.out, "a") as f:
            f.write(json.dumps(rec) + "\n")
        print(summary(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
