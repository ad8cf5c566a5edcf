"""Where K1 spends its cycles, on the card: clock64 probes of both kernels.

    python -m qtpu_torch.ops.probe_k1 [--out probe_k1.json]

It builds ``csrc/qmatmul.cu`` once more with ``-DQTPU_IGEMM_PROBE
-DQTPU_WGMMA_PROBE`` (a library of its own; the kernels every other caller
loads are built without the flags and carry no probe code), and runs the
ResNet-50 K1 rows (K = 64, 256 and 1024, at B = 8 and B = 128) through
both kernels.

* The old ``mma.sync`` loop (``igemm.cuh: igemm_kernel``, entry
  ``qtpu_qmatmul_fused_igemm``): thread 0 of every block stamps
  ``clock64()`` at its start, once its loaders have resolved their rows,
  after the main loop and after the epilogue has issued its stores, with
  its SM id and the main loop's cycles by phase (issuing copies, waiting
  for them, mma).  Reported over the blocks: set-up, main loop cycles per
  block and per 64-byte k-tile and by phase, epilogue cycles, the
  epilogue's share, and the most blocks of one SM whose spans overlap.
* The TMA + ``wgmma`` kernel (``wgmma_gemm.cuh``, entry
  ``qtpu_qmatmul_fused``): each persistent block sums its cycles by phase
  (the consumers' wait for a full stage; unpack, wgmma issue and wait; the
  epilogue's start; the wait for the residual; the epilogue's arithmetic
  and store issue; the producer's waits for a free stage and a free
  residual buffer).  Reported as cycles per tile, averaged over the blocks.

Each row also gives the kernel's device time by CUDA events (a probe
launch) and checks the output against the plain version.  Cycles are SM
clocks (``clocks.sm`` under load, read from ``nvidia-smi``).  Needs one
CUDA device; nothing here runs on the CPU.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

from qtpu_torch.bench.timing import device_label
from qtpu_torch.ops import _build, qops
from qtpu_torch.ops import qmatmul as k1

DEFINES = ("-DQTPU_IGEMM_PROBE", "-DQTPU_WGMMA_PROBE")
# (label, M at B = 8, K, N, epilogue, residual): ResNet-50's K1 rows; the
# B = 128 rows are the same GEMMs with M x 16
ROWS = [
    ("layer1 conv3 +int8 residual, requant", 25088, 64, 256, "res", True),
    ("layer1 conv1 requant", 25088, 256, 64, "requant", False),
    ("layer2_0 downsample f32", 6272, 256, 512, "f32", False),
    ("layer3 conv1 requant", 1568, 1024, 256, "requant", False),
]
WGMMA_PHASES = ("wait_full", "mma", "epilogue_start", "wait_residual",
                "epilogue", "producer_wait_stage", "producer_wait_residual")


def _coeffs(n, k, g, dev, kind):
    kw = {"res": dict(requant_scale=0.05, requant_zp=-20, relu=True,
                      res_scale=0.04, res_zp=-7),
          "requant": dict(requant_scale=0.05, requant_zp=-20, relu=True),
          "f32": {}}[kind]
    return qops.epilogue_coeffs(
        act_scale=0.02, act_zp=-9,
        w_scale=(torch.rand(n, generator=g) * 0.01 + 1e-3).to(dev),
        colsum=torch.randint(-127 * k // 8, 127 * k // 8, (n,), generator=g,
                             dtype=torch.int32).to(dev),
        bias=torch.randn(n, generator=g).to(dev), **kw)


def check(cond, what):
    if cond is True or cond == 0:
        return
    raise RuntimeError(f"probe: {what} failed ({cond})")


def _sm_mhz() -> float:
    return float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,"
         "nounits"], capture_output=True, text=True,
        timeout=60).stdout.split()[0])


def probe_row(label, M, K, N, kind, res, g, dev):
    x = torch.randint(-128, 128, (M, K), generator=g, dtype=torch.int8).to(dev)
    w = torch.randint(-127, 128, (N, K), generator=g, dtype=torch.int8).to(dev)
    r = (torch.randint(-128, 128, (M, N), generator=g, dtype=torch.int8)
         .to(dev) if res else None)
    co, mode = _coeffs(N, K, g, dev, kind)
    odt = k1.out_dtype_of(mode, torch.float32, False)
    out = torch.empty((M, N), dtype=odt, device=dev)
    ref = k1.qmatmul_folded_plain(x, w, co, mode, r)
    A, B, C, lo, hi, shift, relu, use_am, am = k1.launch_args(co, mode)
    setter = {"igemm": "qtpu_probe_set_stamps",
              "wgmma": "qtpu_wgmma_probe_set"}
    row = dict(label=label, M=M, K=K, N=N, ktiles=-(-K // 64))
    for path, symbol in (("igemm", "qtpu_qmatmul_fused_igemm"),
                         ("wgmma", "qtpu_qmatmul_fused")):
        fn = _build.load("qmatmul", symbol, k1._ARGTYPES, DEFINES)
        if path == "igemm":
            big = N >= 128 and -(-M // 128) * -(-N // 128) >= 264
            bm = 128 if big else 64
            nblk = -(-M // bm) * -(-N // bm)
            row["igemm_tile"] = f"{bm}x{bm}"
        else:
            # at most six blocks per SM
            nblk = 6 * torch.cuda.get_device_properties(
                dev).multi_processor_count
        buf = torch.zeros((nblk, 8), dtype=torch.int64, device=dev)
        setp = _build.load("qmatmul", setter[path], (k1.ctypes.c_void_p,),
                           DEFINES)
        check(setp(buf.data_ptr()), setter[path])

        def launch():
            check(fn(x.data_ptr(), w.data_ptr(), A, B,
                     None if r is None else r.data_ptr(),
                     k1.RES_KIND[None if r is None else r.dtype],
                     out.data_ptr(), k1.OUT_KIND[odt], M, N, K, C, lo, hi,
                     shift, relu, use_am, am,
                     torch.cuda.current_stream().cuda_stream), symbol)

        for _ in range(3):
            launch()
        torch.cuda.synchronize()
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        for _ in range(20):
            launch()
        b.record()
        torch.cuda.synchronize()
        row[f"{path}_ms"] = a.elapsed_time(b) / 20
        check(torch.equal(out, ref), f"{label} ({path}): differs from plain")
        buf.zero_()
        launch()
        torch.cuda.synchronize()
        s = buf.cpu()
        if path == "igemm":
            row.update(_igemm_stats(s, row["ktiles"]))
        else:
            used = s[s[:, 7] > 0]
            tiles = used[:, 7].sum().item()
            row["wgmma_blocks"] = int(len(used))
            row["wgmma_tiles_per_block"] = tiles / max(len(used), 1)
            for i, name in enumerate(WGMMA_PHASES):
                row[f"wgmma_{name}_cycles_per_tile"] = (
                    used[:, i].sum().item() / max(tiles, 1))
    return row


def _igemm_stats(s, ktiles):
    """The old loop's stamps (igemm.cuh: start, loaders set up, main loop
    end, epilogue end, SM, main-loop cycles issuing copies, waiting for
    them, in mma) as medians over the blocks."""
    setup = (s[:, 1] - s[:, 0]).double()
    loop = (s[:, 2] - s[:, 1]).double()
    epi = (s[:, 3] - s[:, 2]).double()
    tot = (s[:, 3] - s[:, 0]).double()
    resident = 0       # blocks of one SM running side by side
    for sm in s[:, 4].unique():
        ev = []
        for t0, t2 in s[s[:, 4] == sm][:, [0, 3]].tolist():
            ev += [(t0, 1), (t2, -1)]
        depth = 0
        for _, d in sorted(ev):
            depth += d
            resident = max(resident, depth)
    return dict(igemm_setup_cycles_median=float(setup.median()),
                igemm_issue_cycles_median=float(s[:, 5].double().median()),
                igemm_wait_cycles_median=float(s[:, 6].double().median()),
                igemm_mma_cycles_median=float(s[:, 7].double().median()),
                igemm_loop_cycles_median=float(loop.median()),
                igemm_loop_cycles_per_ktile=float(loop.median()) / ktiles,
                igemm_epilogue_cycles_median=float(epi.median()),
                igemm_block_cycles_median=float(tot.median()),
                igemm_epilogue_share=float(epi.sum() / tot.sum()),
                igemm_blocks_per_sm_side_by_side=resident)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", help="also write the rows as JSON here")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("probe_k1: needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    card = device_label(dev)
    print(card, flush=True)
    _build.build(["qmatmul"], DEFINES)
    g = torch.Generator().manual_seed(0)
    rows = []
    for batch in (8, 128):
        for label, M, K, N, kind, res in ROWS:
            row = probe_row(f"B={batch} {label}", M * batch // 8, K, N, kind,
                            res, g, dev)
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
