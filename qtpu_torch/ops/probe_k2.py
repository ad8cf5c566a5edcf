"""Where K2 spends its cycles, on the card: clock64 probes of its kernels.

    python -m qtpu_torch.ops.probe_k2 [--out probe_k2.json] [--small]

It builds ``csrc/qconv.cu`` once more with ``-DQTPU_IGEMM_PROBE
-DQTPU_WGMMA_PROBE -DQTPU_STEM_PROBE`` (a library of its own; the kernels
every other caller loads carry no probe code) and runs four K2 rows:
ResNet-50's layer1 3×3 (B = 128, 56², Ci = Co = 64, K = 576) and layer3
3×3 (B = 128, 14², Ci = Co = 256, K = 2,304), and MobileNet-v1's int8 stem
(224² → 112², Ci = 3, Co = 32, 3×3/2) at B = 8 and 128, each through the
old loop and through the kernel ``ops/qconv.k2_path`` gives it.

* The old ``mma.sync`` loop (``igemm.cuh: igemm_kernel`` with qconv.cu's
  loader, on the zero-point-padded input): thread 0 of every block stamps
  ``clock64()`` at its start, once the loaders have resolved their rows
  (the per-row division by OW and OH), after the main loop and after the
  epilogue has issued its stores, with its SM id and the main loop's cycles
  by phase: issuing the copies (the loader's address arithmetic — per
  16-byte chunk a division by Ci and KW — and the cp.async instructions),
  waiting for them to land, and the fragment loads and mma.sync.  Reported
  as medians over the blocks.
* The implicit GEMM on the ring (``wgmma_gemm.cuh`` with qconv.cu's im2col
  policy): each persistent block sums its cycles by phase, as in
  ``probe_k1`` (the pad correction counts with the wgmma wait); reported as
  cycles per tile, averaged over the blocks.
* The stem kernel: thread 0 of each persistent block sums its cycles by
  phase (staging the band's input rows, the A fragments and mma.sync, the
  requant into the output tile, issuing the TMA stores); reported as
  cycles per band, averaged over the blocks.

Each row also gives each kernel's device time by CUDA events (probe
launches) and checks its output against the plain version.

``--small`` instead times the small-channel kernel (``k2_path``'s
``"small"``, the normal build) with each multiply forced — ``mma.sync``, a
warp's 16 pixels, and ``wgmma`` with A from registers, a warpgroup's 64 —
beside the old loop on its zero-point-padded copy, graph-timed (launched one
by one they would time the host), at the rows it took over
(:data:`SMALL_ROWS`: LeNet-5's convs, config 3's raw stem, ResNet-20's 16-
and 32-channel 3×3s, at B = 8 and 128), each checked against the plain
version: the measurement behind ``csrc/qconv.cu``'s ``small_wgmma``.  Cycles are SM
clocks (``clocks.sm`` under load, read from ``nvidia-smi``).  Needs one
CUDA device; nothing here runs on the CPU.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

from qtpu_torch.bench.timing import device_label, timed
from qtpu_torch.ops import _build, qops
from qtpu_torch.ops import qconv as k2
from qtpu_torch.ops import qmatmul as k1
from qtpu_torch.ops.probe_k1 import (WGMMA_PHASES, _coeffs, _igemm_stats,
                                     _sm_mhz, check)

DEFINES = ("-DQTPU_IGEMM_PROBE", "-DQTPU_WGMMA_PROBE", "-DQTPU_STEM_PROBE")
# (label, B, H, Ci, Co, kernel, stride)
ROWS = [
    ("B=128 layer1 conv2 3x3/1", 128, 56, 64, 64, 3, 1),
    ("B=128 layer3 conv2 3x3/1", 128, 14, 256, 256, 3, 1),
    ("B=8 MNv1 int8 stem 3x3/2", 8, 224, 3, 32, 3, 2),
    ("B=128 MNv1 int8 stem 3x3/2", 128, 224, 3, 32, 3, 2),
]
STEM_PHASES = ("stage_rows", "mma", "epilogue", "store_issue")
# (label, B, H, Ci, Co, kernel, stride, padding, zp, raw)
SMALL_ROWS = [(f"B={B} {label}", B, *shape) for B in (8, 128)
              for label, *shape in (
                  ("LeNet conv1 5x5 SAME raw", 28, 1, 6, 5, 1, "SAME", -17,
                   True),
                  ("LeNet conv2 5x5 VALID raw", 14, 6, 16, 5, 1, "VALID", 5,
                   True),
                  ("RN20 layer1 3x3/1", 32, 16, 16, 3, 1, "SAME", 0, False),
                  ("RN20 layer2_0 3x3/2", 32, 16, 32, 3, 2, "SAME", 0,
                   False),
                  ("RN20 layer2 3x3/1", 16, 32, 32, 3, 1, "SAME", 0, False),
                  ("RN20 layer3_0 3x3/2", 16, 32, 64, 3, 2, "SAME", 0,
                   False))] + [
    ("B=16 cfg3 QAT stem 3x3/2 raw", 16, 224, 3, 32, 3, 2, "SAME", -5,
     True)]
_SETTERS = {"igemm": "qtpu_probe_set_stamps", "wgmma": "qtpu_wgmma_probe_set",
            "stem": "qtpu_stem_probe_set"}


def _events_ms(launch, n=20):
    for _ in range(3):
        launch()
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(n):
        launch()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / n


def probe_row(label, B, H, Ci, Co, k, s, g, dev):
    x = torch.randint(-128, 128, (B, H, H, Ci), generator=g,
                      dtype=torch.int8).to(dev)
    K = k * k * Ci
    w = torch.randint(-127, 128, (Co, K), generator=g, dtype=torch.int8).to(dev)
    co, mode = _coeffs(Co, K, g, dev, "requant")
    zp = -9
    pads = qops.same_pads((H, H), (k, k), (s, s))
    ref = k2.qconv2d_folded_plain(x, w, co, mode, kernel_hw=(k, k), stride=s,
                                  pads=pads, zp=zp)
    OH, OW = ref.shape[1:3]
    M = B * OH * OW
    out = torch.empty_like(ref)
    A, Bv, C, lo, hi, shift, relu, use_am, am = k1.launch_args(co, mode)
    new = k2.k2_path(x, w, pads, s, co, mode, kernel_hw=(k, k))
    row = dict(label=label, M=M, K=K, N=Co, ktiles=-(-K // 64), path=new)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    tapsum = k2.tapsum_of(w, (k, k))
    xp = qops.pad_nhwc(x, pads, zp).contiguous()
    for path in ("igemm", new):
        fn = _build.load("qconv", k2._SYMBOLS[path], k2._ARGTYPES, DEFINES)
        if path == "igemm":
            big = Co >= 128 and -(-M // 128) * -(-Co // 128) >= 264
            bm = 128 if big else 64
            nblk = -(-M // bm) * -(-Co // bm)
            row["igemm_tile"] = f"{bm}x{bm}"
            xa, geo = xp, (xp.shape[1], xp.shape[2], 0, 0)
        else:       # persistent grids: at most six (wgmma), eight blocks an SM
            nblk = 8 * sms
            xa, geo = x, (H, H, pads[0][0], pads[1][0])
        buf = torch.zeros((nblk, 8), dtype=torch.int64, device=dev)
        setp = _build.load("qconv", _SETTERS[path], (k1.ctypes.c_void_p,),
                           DEFINES)
        check(setp(buf.data_ptr()), _SETTERS[path])

        def launch():
            check(fn(xa.data_ptr(), w.data_ptr(), tapsum.data_ptr(), A, Bv,
                     None, 0, out.data_ptr(), k1.OUT_KIND[out.dtype], B,
                     geo[0], geo[1], Ci, Co, k, k, s, geo[2], geo[3], OH, OW,
                     zp, None, C, lo, hi, shift, relu, use_am, am,
                     torch.cuda.current_stream().cuda_stream),
                  f"{path} launch")

        row[f"{path}_ms"] = _events_ms(launch)
        check(torch.equal(out, ref), f"{label} ({path}): differs from plain")
        buf.zero_()
        launch()
        torch.cuda.synchronize()
        st = buf.cpu()
        if path == "igemm":
            row.update(_igemm_stats(st, row["ktiles"]))
            continue
        used = st[st[:, 7] > 0]
        units = used[:, 7].sum().item()
        row[f"{path}_blocks"] = int(len(used))
        unit = "tile" if path == "wgmma" else "band"
        row[f"{path}_{unit}s_per_block"] = units / max(len(used), 1)
        for i, name in enumerate(WGMMA_PHASES if path == "wgmma"
                                 else STEM_PHASES):
            row[f"{path}_{name}_cycles_per_{unit}"] = (
                used[:, i].sum().item() / max(units, 1))
    return row


def small_row(label, B, H, Ci, Co, k, s, padding, zp, raw, g, dev):
    """The small kernel with each multiply forced, and the old loop, at one
    row: device ms a launch from a CUDA graph of 50, each output against the
    plain one."""
    x = torch.randint(-128, 128, (B, H, H, Ci), generator=g,
                      dtype=torch.int8).to(dev)
    K = k * k * Ci
    w = torch.randint(-127, 128, (Co, K), generator=g, dtype=torch.int8).to(dev)
    co, mode = (None, None) if raw else _coeffs(Co, K, g, dev, "requant")
    pads = qops.resolve_pads((H, H), (k, k), (s, s), padding)
    args = dict(kernel_hw=(k, k), stride=s, pads=pads, zp=zp, raw_acc=raw)
    ref = k2.qconv2d_folded_plain(x, w, co, mode, **args)
    xp = qops.pad_nhwc(x, pads, zp).contiguous()
    runs = {"igemm": lambda: k2.qconv2d_folded(
        xp, w, co, mode, kernel_hw=(k, k), stride=s, raw_acc=raw,
        path="igemm")}
    for mma in ("sync", "wgmma") if Co > 8 else ("sync",):
        runs[f"small_{mma}"] = (lambda mma=mma: k2.qconv2d_folded(
            x, w, co, mode, path="small", small_mma=mma, **args))
    row = dict(label=label, M=ref.numel() // Co, K=K, N=Co,
               path=k2.k2_path(x, w, pads, s, co, mode, kernel_hw=(k, k),
                               out_dtype=ref.dtype))
    for name, run in runs.items():
        check(int(not torch.equal(run(), ref)), f"{label} ({name})")
        row[f"{name}_ms"] = timed(run, 50)
    return row


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", help="also write the rows as JSON here")
    p.add_argument("--small", action="store_true",
                   help="time the small kernel's two multiplies instead")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("probe_k2: needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    card = device_label(dev)
    print(card, flush=True)
    g = torch.Generator().manual_seed(0)
    rows = []
    _build.build(["qconv"], () if args.small else DEFINES)
    for spec in SMALL_ROWS if args.small else ():
        rows.append(small_row(*spec, g, dev))
        print(json.dumps(rows[-1]), flush=True)
    for label, B, H, Ci, Co, k, s in () if args.small else ROWS:
        row = probe_row(label, B, H, Ci, Co, k, s, g, dev)
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
