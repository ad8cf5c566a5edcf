"""Where K5 and K6 spend their cycles, on the card: clock64 probes of both
kernels of each.

    python -m qtpu_torch.ops.probe_tail [--out probe_tail.json]
                                        [--paths igemm,wgmma]

It builds ``csrc/qtail.cu`` and ``csrc/qblock.cu`` once more with
``-DQTPU_TAIL_PROBE`` (libraries of their own; the kernels every other
caller loads carry no probe code) and runs ResNet-50's layer1 and layer4
identity blocks (K5: conv2 → conv3 + residual; K6: the whole block) at
B = 8 and B = 128 through the older ``mma.sync`` kernel
(``csrc/fused_tail.cuh``, one block per 8×8 tile) and the wgmma kernel
(``csrc/wgmma_tail.cuh``, a cluster of ``cs`` blocks per tile).  Thread 0
of every block (of the consumer warpgroup, in the wgmma kernel) sums its
``clock64()`` cycles by phase (fused_tail.cuh: TailProbe):

* ``halo`` — the halo's copy (K5) or zero-point fill, and the wait for it;
* ``conv1`` — K6's conv1 on the halo, its requant into the halo;
* ``conv2_loop`` — conv2's main loops; ``conv2_requant`` — their requant
  into ``mid``;
* ``conv3_loop`` — conv3's main loops; ``conv3_epilogue`` — the residual,
  requant and the output's stores;
* ``exchange`` — the wgmma kernel's copies of the halo (K6) and ``mid``
  slices to the cluster's other blocks and the wait for theirs;
* within the wgmma kernel's main loops (conv1's, conv2's and conv3's),
  ``wait_stage`` — the waits for a full ring stage, ``wait_wgmma`` — for
  the wgmmas;

reported as the mean over the blocks of the launch, with the block's total
and the number of blocks.  Each row also gives each kernel's device time by
CUDA events (probe launches) and checks its output against the plain
version.  Cycles are SM clocks (``clocks.sm`` under load, read from
``nvidia-smi``).  Needs one CUDA device; nothing here runs on the CPU.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

from qtpu_torch.bench.timing import device_label
from qtpu_torch.ops import _build, qops
from qtpu_torch.ops import qblock as k6
from qtpu_torch.ops import qtail as k5
from qtpu_torch.ops.probe_k1 import _sm_mhz, check
from qtpu_torch.ops.probe_k2 import _events_ms

DEFINES = ("-DQTPU_TAIL_PROBE",)
PHASES = ("halo", "conv1", "conv2_loop", "conv2_requant", "conv3_loop",
          "conv3_epilogue", "exchange", "wait_stage", "wait_wgmma")
# (kernel, label, B, H, Cmid, Cout): ResNet-50's layer1 and layer4 identity
# blocks
ROWS = [(kind, f"B={B} {stage}", B, H, cmid, 4 * cmid)
        for kind in ("K5", "K6")
        for stage, H, cmid in (("layer1", 56, 64), ("layer4", 7, 512))
        for B in (8, 128)]


def _coeffs(n, k, g, dev, **kw):
    return qops.epilogue_coeffs(
        act_scale=0.02, act_zp=-9,
        w_scale=(torch.rand(n, generator=g) * 0.01 + 1e-3).to(dev),
        colsum=torch.randint(-127 * k // 8, 127 * k // 8, (n,), generator=g,
                             dtype=torch.int32).to(dev),
        bias=torch.randn(n, generator=g).to(dev), requant_scale=0.05,
        requant_zp=-20, relu=True, **kw)


def probe_row(kind, label, B, H, cmid, cout, g, dev, paths):
    def i8(*shape):
        return torch.randint(-128, 128, shape, generator=g,
                             dtype=torch.int8).to(dev)
    w2, w3 = i8(cmid, 9 * cmid), i8(cout, cmid)
    co2, mode2 = _coeffs(cmid, 9 * cmid, g, dev)
    co3, mode3 = _coeffs(cout, cmid, g, dev, res_scale=0.04, res_zp=-7)
    if kind == "K5":
        a, r = i8(B, H, H, cmid), i8(B, H, H, cout)
        args = (a, r, w2, w3, co2, mode2, co3, mode3)
        kw = dict(pad=1, zp=-9)
        fn, plain, lib = k5.qtail_folded, k5.qtail_folded_plain, "qtail"
    else:
        x, w1 = i8(B, H, H, cout), i8(cmid, cout)
        co1, mode1 = _coeffs(cmid, cout, g, dev)
        args = (x, w1, w2, w3, co1, mode1, co2, mode2, co3, mode3)
        kw = dict(zp2=-9)
        fn, plain, lib = k6.qblock_folded, k6.qblock_folded_plain, "qblock"
    ref = plain(*args, **kw)
    tiles = B * (-(-H // k5.TILE)) ** 2
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = k5.tail_plan(B, H, H, cmid, cout, sms=sms, block=kind == "K6")
    row = dict(kernel=kind, label=label, B=B, H=H, Cmid=cmid, Cout=cout,
               tiles=tiles, plan=plan._asdict())
    buf = torch.zeros((tiles * k5.MAX_CS, 10), dtype=torch.int64,
                      device=dev)
    setp = _build.load(lib, "qtpu_tail_probe_set", (k5.ctypes.c_void_p,),
                       DEFINES)
    check(setp(buf.data_ptr()), "qtpu_tail_probe_set")
    for path in paths:
        def launch():
            return fn(*args, **kw, path=path, defines=DEFINES)
        row[f"{path}_ms"] = _events_ms(launch)
        buf.zero_()
        out = launch()
        torch.cuda.synchronize()
        check(torch.equal(out, ref), f"{kind} {label} ({path}): differs "
              "from plain")
        st = buf.cpu()
        used = st[st[:, 9] > 0].double()
        row[f"{path}_blocks"] = int(len(used))
        row[f"{path}_block_cycles"] = float(used[:, 9].mean())
        for i, name in enumerate(PHASES):
            row[f"{path}_{name}_cycles"] = float(used[:, i].mean())
    return row


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", help="also write the rows as JSON here")
    p.add_argument("--paths", default="igemm,wgmma",
                   help="the kernels to probe, of igemm,wgmma")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("probe_tail: needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    card = device_label(dev)
    print(card, flush=True)
    paths = [q for q in args.paths.split(",") if q]
    if not paths or any(q not in k5.PATHS for q in paths):
        p.error(f"--paths takes some of {k5.PATHS}")
    _build.build(["qtail", "qblock"], DEFINES)
    g = torch.Generator().manual_seed(0)
    rows = []
    for kind, label, B, H, cmid, cout in ROWS:
        row = probe_row(kind, label, B, H, cmid, cout, g, dev, paths)
        row["sm_mhz"] = _sm_mhz()
        rows.append(row)
        print(json.dumps(row), flush=True)
        torch.cuda.empty_cache()
    if args.out:
        out = Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps({"card": card, "rows": rows}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
