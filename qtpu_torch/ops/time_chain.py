"""K7's, K8's and K9's device time on the card at the chained engines'
runs: the wgmma runner with the plan ``chain_plan`` picks, the older
kernel forced (``path="igemm"``) and the unfused K1/K2/K3 sequence each
replaces; with ``--sweep`` also every other plan ``chain_plan`` takes.

    python -m qtpu_torch.ops.time_chain [--sweep] [--batches 8,128]
                                        [--kernels K7,K8,K9] [--out FILE]

The rows: K7 at ResNet-50's four identity runs (layer1: 2 blocks of Cin
256 / Cmid 64 at 56²; layer2 3 of 512/128 at 28²; layer3 5 of 1024/256 at
14²; layer4 2 of 2048/512 at 7²), K8 at its whole layer1 (the projection
block Cp 64 / Cm 64 / Co 256, then 2 chained blocks, at 56²) and K9 at
MobileNet-v2's five runs
(block2 1 of C 24 / E 144 at 56²; block4-5 2 of 32/192 at 28²; block7-9 3
of 64/384 at 14²; block11-12 2 of 96/576 at 14²; block14-15 2 of 160/960
at 7²), with ``probe_chain.py``'s coefficients.  Each time is the device
ms of one call, ``--iters`` calls captured in one CUDA graph and the replay
timed with CUDA events (the three variants of a row in turns: new, old,
unfused, unfused, old, new; each row reports the mean of its two).  Every
output is checked against the plain version; the sweep's plans against
the automatic plan's.  The sweep reports, per row, the best plan and
whether ``chain_plan``'s is within 7% of it.  Needs one CUDA device.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

from qtpu_torch.bench.timing import device_label, timed
from qtpu_torch.ops import _build
from qtpu_torch.ops import chain_plan as cp
from qtpu_torch.ops import qconv as k2
from qtpu_torch.ops import qdepthwise as k3
from qtpu_torch.ops import qivr as k9
from qtpu_torch.ops import qmatmul as k1
from qtpu_torch.ops import qops
from qtpu_torch.ops import qstage as k7
from qtpu_torch.ops.probe_chain import RUNS, chain_case
from qtpu_torch.ops.qproj import DOWN_MODE

PAD1 = ((1, 1), (1, 1))
PLAN_KIND = {"K7": "stage", "K8": "stage_proj", "K9": "ivr"}


def unfused(kind, x, w1, w2, w3, co):
    """The sequence the product engines run instead: per block K1 → K2 (on
    the zero-point-padded codes) → K1 + residual (K7), K1 → K3 → K1 +
    residual (K9)."""
    B, H, W, c = x.shape
    for i in range(w1.shape[0]):
        (co1, m1), (co2, m2), (co3, m3), zp = co.block(i)
        a = k1.qmatmul_folded(x.reshape(-1, c), w1[i], co1, m1)
        cm = a.shape[-1]
        if kind == "K7":
            b = k2.qconv2d_folded(qops.pad_nhwc(a.reshape(B, H, W, cm), PAD1,
                                                zp), w2[i], co2, m2,
                                  kernel_hw=(3, 3))
        else:
            b = k3.qdepthwise_folded(a.reshape(B, H, W, cm), w2[i], co2, m2,
                                     kernel_hw=(3, 3), stride=1,
                                     padding="SAME", zp=zp)
        x = k1.qmatmul_folded(b.reshape(-1, cm), w3[i], co3, m3,
                              x.reshape(-1, c)).reshape(B, H, W, c)
    return x


def unfused_stage(x, wp1, wp2, wp3, wd, pco, cod, w1, w2, w3, co):
    """K8's sequence unfused: the projection block's K1 → K2 → K1 f32
    downsample → K1 + f32 residual, then :func:`unfused` of the chain."""
    B, H, W, cp_ = x.shape
    (co1, m1), (co2, m2), (co3, m3), zp = pco.block(0)
    a = k1.qmatmul_folded(x.reshape(-1, cp_), wp1, co1, m1)
    b = k2.qconv2d_folded(qops.pad_nhwc(a.reshape(B, H, W, -1), PAD1, zp),
                          wp2, co2, m2, kernel_hw=(3, 3))
    td = k1.qmatmul_folded(x.reshape(-1, cp_), wd, cod, DOWN_MODE)
    x1 = k1.qmatmul_folded(b.reshape(-1, b.shape[-1]), wp3, co3, m3, td)
    return unfused("K7", x1.reshape(B, H, W, -1), w1, w2, w3, co)


def plans(kind, B, H, c, cm, sms):
    """Every plan ``chain_plan`` takes for the row (both modes; two tiles a
    unit only for K7's fused mode)."""
    out = []
    for mode in cp.MODES:
        for tm in ((1, 2) if kind != "K9" and mode == "fused" else (1,)):
            pl = cp.chain_plan(PLAN_KIND[kind], B, H, H, c, cm, sms=sms,
                               mode=mode, tm=tm)
            if pl is not None:
                out.append(pl)
    return out


def row(kind, label, B, H, c, cm, n, g, dev, sweep, iters, sms):
    args = chain_case(kind, B, H, c, cm, n, g, dev)
    fn, plain = {"K7": (k7.qstage_folded, k7.qstage_folded_plain),
                 "K8": (k7.qstage_proj_folded, k7.qstage_proj_folded_plain),
                 "K9": (k9.qivr_folded, k9.qivr_folded_plain)}[kind]
    pk = PLAN_KIND[kind]
    ref = plain(*args)
    runs = {"new": lambda: fn(*args), "old": lambda: fn(*args, path="igemm"),
            "unfused": lambda: (unfused_stage(*args) if kind == "K8" else
                                unfused(kind, *args))}
    for name, run in runs.items():
        if not torch.equal(run(), ref):
            raise RuntimeError(f"{kind} {label} B={B}: {name} differs from "
                               "plain")
    ms = {k: 0.0 for k in runs}
    for name in ("new", "old", "unfused", "unfused", "old", "new"):
        ms[name] += timed(runs[name], iters) / 2
    if kind == "K8":    # c: (Cp, Cm, Co); the plan's widths Co, Cm
        path = k7.stage_proj_path(B, H, H, *c, cm, args[5], args[-1], n,
                                  *args[:5], *args[7:10], sms=sms)
        c, cm = c[2], c[1]
    elif kind == "K7":
        path = k7.stage_path(B, H, H, c, cm, args[-1], *args[:4], sms=sms)
    else:
        path = k9.ivr_path(B, H, H, c, cm, args[-1], *args[:4], sms=sms)
    plan = cp.chain_plan(pk, B, H, H, c, cm, sms=sms)
    out = dict(kernel=kind, label=label, B=B, H=H, C=c, Cm=cm, blocks=n,
               path=path, plan=plan._asdict() if plan else None,
               **{f"{k}_ms": v for k, v in ms.items()}, sweep=[])
    if sweep and path == "wgmma":
        for pl in plans(kind, B, H, c, cm, sms):
            if not torch.equal(fn(*args, plan=pl), ref):
                raise RuntimeError(f"{kind} {label} B={B} {pl}: differs")
            out["sweep"].append(dict(mode=pl.mode, tm=pl.tm, ms=timed(
                lambda pl=pl: fn(*args, plan=pl), iters)))
        best = min(out["sweep"], key=lambda r: r["ms"])
        auto = next(r for r in out["sweep"] if r["mode"] == plan.mode
                    and r["tm"] == plan.tm)
        out["best"] = best
        out["plan_within_7pct"] = auto["ms"] <= 1.07 * best["ms"]
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--sweep", action="store_true",
                   help="also time every plan chain_plan takes")
    p.add_argument("--batches", default="8,128")
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--kernels", default="K7,K8,K9",
                   help="the rows to time, of K7,K8,K9")
    p.add_argument("--out", help="also write the rows as JSON here")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("time_chain: needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    card = device_label(dev)
    print(card, flush=True)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    _build.build(["qmatmul", "qconv", "qdepthwise", "qstage", "qivr",
                  "qstage_wg", "qstage_proj_wg", "qivr_wg"])
    g = torch.Generator().manual_seed(0)
    rows = []
    for B in (int(b) for b in args.batches.split(",")):
        for kind in args.kernels.split(","):
            for label, H, c, cm, n in RUNS[kind]:
                r = row(kind, label, B, H, c, cm, n, g, dev, args.sweep,
                        args.iters if B <= 8 else max(args.iters // 4, 3),
                        sms)
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
