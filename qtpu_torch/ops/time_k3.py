"""K3's device time on the card at MobileNet-v2's depthwise rows: the plan
``k3_plan`` picks and, with ``--sweep``, every other halo plan of a grid.

    python qtpu_torch/ops/time_k3.py [--root CHECKOUT] [--sweep] [--out FILE]

``--root`` times the ``qtpu_torch`` of another checkout (default: the one
holding this file; the checkout must have ``qtpu_torch/bench/timing.py``,
whose graph timer times the rows), built from that checkout's sources into its own build
directory, so that one call can time a parent commit's K3 beside this
one's; a checkout whose K3 has no plans is timed through its wrapper
alone.  The rows: B = 8 and 128 at block1 (112² C = 96 /2), block2 (56²
C = 144 /1) and block14 (7² C = 960 /1), the 3×3 SAME depthwise with the
relu6 requant of ``chip_smoke.py``'s K3 rows.  Each time is the device ms
of one call, 50 calls captured in one CUDA graph and the replay timed with
CUDA events.  The sweep takes rows a block in {1, 2, 4, 7, 8, 14}, channels
a block in the multiples of 16 that divide C up to 192 and threads in
{32, 64, 128, 256}, within the kernel's limits, and checks each plan's
output against the automatic plan's.  Needs one CUDA device.
"""
from __future__ import annotations

import argparse
import itertools
import json
import sys
from pathlib import Path

# (label, B, H, C, stride)
ROWS = [
    ("block1 dw 3x3/2", 8, 112, 96, 2),
    ("block2 dw 3x3/1", 8, 56, 144, 1),
    ("block14 dw 3x3/1", 8, 7, 960, 1),
    ("B=128 block1 dw 3x3/2", 128, 112, 96, 2),
    ("B=128 block2 dw 3x3/1", 128, 56, 144, 1),
    ("B=128 block14 dw 3x3/1", 128, 7, 960, 1),
]
ITERS = 50          # calls captured in one CUDA graph


def plans(k3, B, H, C, s, sms):
    """The halo plans of the sweep's grid that the kernel takes."""
    OH = -(-H // s)
    Wt = (OH - 1) * s + 3
    for th, cc, threads in itertools.product(
            (1, 2, 4, 7, 8, 14), range(16, min(C, 192) + 1, 16),
            (32, 64, 128, 256)):
        if (th <= OH and C % cc == 0
                and ((th - 1) * s + 3) * Wt * cc <= k3.HALO_SMEM):
            yield k3.DwPlan("halo", th, cc, threads)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--root", default=str(Path(__file__).resolve().parents[2]),
                   help="the checkout whose qtpu_torch is timed")
    p.add_argument("--sweep", action="store_true",
                   help="also time every halo plan of the grid")
    p.add_argument("--out", help="also write the rows as JSON here")
    args = p.parse_args(argv)
    root = str(Path(args.root).resolve())
    sys.path.insert(0, root)
    import torch
    from qtpu_torch.bench.timing import device_label, timed
    from qtpu_torch.ops import qdepthwise as k3
    from qtpu_torch.ops import qops
    if not torch.cuda.is_available():
        print("time_k3: needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    card = device_label(dev)
    print(card, flush=True)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    g = torch.Generator().manual_seed(0)
    rows = []
    for label, B, H, C, s in ROWS:
        x = torch.randint(-128, 128, (B, H, H, C), generator=g,
                          dtype=torch.int8).to(dev)
        w = torch.randint(-127, 128, (9, C), generator=g,
                          dtype=torch.int8).to(dev)
        co = qops.epilogue_coeffs(
            act_scale=0.02, act_zp=-9,
            w_scale=(torch.rand(C, generator=g) * 0.01 + 1e-3).to(dev),
            colsum=w.int().sum(0), bias=torch.randn(C, generator=g).to(dev),
            requant_scale=0.05, requant_zp=-20, relu=True, act_max=6.0)

        def run(plan=None):
            kw = {} if plan is None else dict(plan=plan)
            return k3.qdepthwise_folded(x, w, *co, kernel_hw=(3, 3),
                                        stride=s, padding="SAME", zp=-9,
                                        **kw)

        row = dict(label=label, root=root, ms=timed(run, ITERS))
        if hasattr(k3, "k3_plan"):
            OH = -(-H // s)
            row["plan"] = list(k3.k3_plan(B, H, H, C, OH, OH, (3, 3), s,
                                          sms=sms))
        if args.sweep and hasattr(k3, "k3_plan"):
            ref = run()
            swept = []
            for plan in plans(k3, B, H, C, s, sms):
                if not torch.equal(run(plan), ref):
                    raise SystemExit(f"{label}: plan {plan} differs")
                swept.append((timed(lambda: run(plan), ITERS),
                              list(plan[1:])))
            swept.sort()
            row["best"] = swept[:5]
            row["n_plans"] = len(swept)
        rows.append(row)
        print(json.dumps(row), flush=True)
        del x, w
        torch.cuda.empty_cache()
    if args.out:
        out = Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps({"card": card, "rows": rows}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
