"""K5's and K6's device time on the card at ResNet-50's identity blocks: the
plan ``tail_plan`` picks and, with ``--sweep``, every other cluster size
(1-8 blocks) and tiles a block (1 or 2) the shape allows.

    python -m qtpu_torch.ops.time_tail [--sweep] [--out FILE]

The rows: K5 (qtail) and K6 (qblock) at layer1-layer4 (56² Cmid 64, 28²
128, 14² 256, 7² 512; Cout = 4·Cmid), B = 8 and 128, with the requant
coefficients of ``chip_smoke.py``'s rows.  Each time is the device ms of
one call, 20 calls captured in one CUDA graph and the replay timed with
CUDA events.  Every plan's output is checked against the automatic plan's.
Needs one CUDA device.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

from qtpu_torch.bench.timing import device_label, timed
from qtpu_torch.ops import qblock as k6
from qtpu_torch.ops import qtail as k5
from qtpu_torch.ops.probe_tail import _coeffs

# (stage, H, Cmid) of ResNet-50's identity blocks
STAGES = (("layer1", 56, 64), ("layer2", 28, 128), ("layer3", 14, 256),
          ("layer4", 7, 512))


def row(kind, B, stage, H, cmid, g, dev, sweep, sms):
    cout = 4 * cmid

    def i8(*shape):
        return torch.randint(-128, 128, shape, generator=g,
                             dtype=torch.int8).to(dev)
    w2, w3 = i8(cmid, 9 * cmid), i8(cout, cmid)
    co2, mode2 = _coeffs(cmid, 9 * cmid, g, dev)
    co3, mode3 = _coeffs(cout, cmid, g, dev, res_scale=0.04, res_zp=-7)
    if kind == "K5":
        a, r = i8(B, H, H, cmid), i8(B, H, H, cout)

        def run(**kw):
            return k5.qtail_folded(a, r, w2, w3, co2, mode2, co3, mode3,
                                   pad=1, zp=-9, **kw)
    else:
        x, w1 = i8(B, H, H, cout), i8(cmid, cout)
        co1, mode1 = _coeffs(cmid, cout, g, dev)

        def run(**kw):
            return k6.qblock_folded(x, w1, w2, w3, co1, mode1, co2, mode2,
                                    co3, mode3, zp2=-9, **kw)
    block = kind == "K6"
    auto = k5.tail_plan(B, H, H, cmid, cout, sms=sms, block=block)
    ref = run()
    out = dict(kernel=kind, B=B, stage=stage, plan=auto._asdict(),
               ms=timed(run, 20), sweep=[])
    if sweep:
        for cs, tm in ((cs, tm) for cs in (1, 2, 4, 8) for tm in (1, 2)):
            if cs > k5.cluster_max(cmid, cout) or (cs, tm) == (auto.cs,
                                                               auto.tm):
                continue
            kw = dict(cs=cs, tm=tm)
            plan = k5.tail_plan(B, H, H, cmid, cout, sms=sms, block=block,
                                **kw)
            if plan is None:
                continue
            if not torch.equal(run(**kw), ref):
                raise RuntimeError(f"{kind} B={B} {stage} {kw}: differs "
                                   "from the plan's")
            out["sweep"].append(dict(
                **kw, stages=plan.stages, per_sm=plan.per_sm,
                ms=timed(lambda: run(**kw), 20)))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--sweep", action="store_true",
                   help="also time every cluster size and tiles a block")
    p.add_argument("--out", help="also write the rows as JSON here")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("time_tail: needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    card = device_label(dev)
    print(card, flush=True)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    g = torch.Generator().manual_seed(0)
    rows = []
    for kind in ("K5", "K6"):
        for B in (8, 128):
            for stage, H, cmid in STAGES:
                r = row(kind, B, stage, H, cmid, g, dev, args.sweep, sms)
                rows.append(r)
                print(json.dumps(r), flush=True)
                torch.cuda.empty_cache()
    if args.out:
        out = Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps({"card": card, "rows": rows}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
