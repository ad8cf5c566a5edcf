"""Where K4 (qproj) spends its cycles, on the card: a clock64 probe of the
older ``igemm.cuh`` kernel.

    python -m qtpu_torch.ops.probe_k4 [--out FILE] [--batches 8,128]

It builds ``csrc/qproj.cu`` once more with ``-DQTPU_PROJ_PROBE
-DQTPU_IGEMM_PROBE`` (a library of its own; the kernels every other caller
loads carry no probe code) and runs the older kernel (entry
``qtpu_qproj_fused_igemm``: one block per output tile, two ``mma.sync``
mainloops, td in registers, one byte store per output) at ResNet-50's
layer1_0 (stride 1) and layer3_0 (stride 2) projection blocks at each
batch.  Thread 0 of every block writes its ``clock64()`` cycles by phase:
the downsample mainloop's copies (issuing the cp.async copies and waiting
for them) and its ``mma.sync``; td's dequant; conv3's copies and
``mma.sync``; the epilogue (requant and byte stores); the block's total.
Reported as the mean over the blocks and as shares of the mean total, with
the most blocks one SM ran.

Each row also gives the older kernel's device time by CUDA events (probe
launches) and checks its output and the wgmma kernel's against the plain
version.  Cycles are SM clocks
(``clocks.sm`` under load, from ``nvidia-smi``).  Needs one CUDA device;
nothing here runs on the CPU.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import sys
from pathlib import Path

import torch

from qtpu_torch.bench.timing import device_label
from qtpu_torch.ops import _build
from qtpu_torch.ops import qproj as k4
from qtpu_torch.ops.probe_chain import _coeffs
from qtpu_torch.ops.probe_k1 import _sm_mhz, check
from qtpu_torch.ops.probe_k2 import _events_ms

DEFINES = ("-DQTPU_PROJ_PROBE", "-DQTPU_IGEMM_PROBE")
PHASES = ("down_copy", "down_mma", "td", "conv3_copy", "conv3_mma",
          "epilogue")
# (label, Hx, Cmid, Cout, Cin, stride): the block input's H
ROWS = (("layer1_0", 56, 64, 256, 64, 1), ("layer3_0", 28, 256, 1024, 512, 2))


def proj_case(B, Hx, cmid, cout, cin, stride, g, dev):
    """(b, x, w3, wd, co3, mode3, cod) of a projection block on random
    codes with ``chip_smoke.py``'s coefficients."""
    def i8(*shape, lo=-128):
        return torch.randint(lo, 128, shape, generator=g,
                             dtype=torch.int8).to(dev)
    H = -(-Hx // stride)
    co3, mode3 = _coeffs(cout, cmid, g, dev, requant_scale=0.05,
                         requant_zp=-20, relu=True, res_f32=True)
    cod, _ = _coeffs(cout, cin, g, dev)
    return (i8(B, H, H, cmid), i8(B, Hx, Hx, cin), i8(cout, cmid, lo=-127),
            i8(cout, cin, lo=-127), co3, mode3, cod)


def probe_row(label, B, Hx, cmid, cout, cin, stride, g, dev):
    args = proj_case(B, Hx, cmid, cout, cin, stride, g, dev)
    ref = k4.qproj_folded_plain(*args, stride=stride)
    row = dict(label=label, B=B, Hx=Hx, Cmid=cmid, Cout=cout, Cin=cin,
               stride=stride)
    H = -(-Hx // stride)
    M = B * H * H
    big = M >= 128 and ((M + 127) // 128) * (cout // 128) >= 264
    bm, bn = (128, 128) if big else (64, 64)
    blocks = -(-M // bm) * -(-cout // bn)
    buf = torch.zeros((blocks, 8), dtype=torch.int64, device=dev)
    setp = _build.load("qproj", "qtpu_proj_probe_set", (ctypes.c_void_p,),
                       DEFINES)
    check(setp(buf.data_ptr()), "qtpu_proj_probe_set")
    new = k4.qproj_folded(*args, stride=stride, defines=DEFINES)
    torch.cuda.synchronize()
    check(torch.equal(new, ref), f"K4 {label} B={B} (wgmma): differs from "
          "plain")

    def launch():
        return k4.qproj_folded(*args, stride=stride, path="igemm",
                               defines=DEFINES)
    row["igemm_ms"] = _events_ms(launch)
    buf.zero_()
    out = launch()
    torch.cuda.synchronize()
    check(torch.equal(out, ref), f"K4 {label} B={B} (igemm): differs from "
          "plain")
    st = buf.cpu().double()
    total = float(st[:, 6].mean())
    row.update(tile=f"{bm}x{bn}", blocks=blocks, block_cycles=total,
               max_blocks_per_sm=int(torch.bincount(st[:, 7].long()).max()))
    for i, name in enumerate(PHASES):
        row[f"{name}_cycles"] = float(st[:, i].mean())
        row[f"{name}_share"] = float(st[:, i].mean()) / total
    return row


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", help="also write the rows as JSON here")
    p.add_argument("--batches", default="8,128")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("probe_k4: needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    card = device_label(dev)
    print(card, flush=True)
    _build.build(["qproj"], DEFINES)
    g = torch.Generator().manual_seed(0)
    rows = []
    for B in (int(b) for b in args.batches.split(",")):
        for label, Hx, cmid, cout, cin, stride in ROWS:
            r = probe_row(label, B, Hx, cmid, cout, cin, stride, g, dev)
            r["sm_mhz"] = _sm_mhz()
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
