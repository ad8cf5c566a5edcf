"""The spreads a bound is set from, out of ``series.py``'s JSON lines:

    python3 benchmark/tools/spreads.py <file.jsonl> ...

For each cell, the untraced runs in two sets — a seed's first run in the
first set, its second in the second — and for each end-to-end metric each
set's median and spread (the quartiles' distance over the median, as
``statistics.quantiles(values, n=4)`` gives them), the wider of the two,
five times it (the bound it suggests, never under 1%), and the second
set's median against the first's.
"""
from __future__ import annotations

import json
import statistics
import sys
from collections import defaultdict

sys.path.insert(0, __file__.rsplit("/benchmark/", 1)[0])

from benchmark.harness.stats import spread  # noqa: E402


def main(paths) -> int:
    sets = defaultdict(lambda: ([], []))
    seen = defaultdict(int)
    for path in paths:
        for line in open(path):
            rec = json.loads(line)
            if rec["trace"] or "result" not in rec:
                continue
            key = (rec["workload"], rec["seed"])
            which = min(seen[key], 1)
            seen[key] += 1
            sets[rec["workload"]][which].append(rec["result"]["metrics"])
    for cell, (a, b) in sorted(sets.items()):
        print(f"{cell}: {len(a)} + {len(b)} runs")
        for name in sorted(a[0]) if a else []:
            va = [m[name]["value"] for m in a]
            vb = [m[name]["value"] for m in b]
            row = [f"  {name}: A median {statistics.median(va):.6g} "
                   f"spread {spread(va):.4%}"]
            if len(vb) >= 2:
                wide = max(spread(va), spread(vb))
                row.append(f"B median {statistics.median(vb):.6g} spread "
                           f"{spread(vb):.4%}; widest {wide:.4%}, x5 "
                           f"{max(0.01, 5 * wide):.4f}; B/A "
                           f"{statistics.median(vb) / statistics.median(va):.5f}")
            print("; ".join(row))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
