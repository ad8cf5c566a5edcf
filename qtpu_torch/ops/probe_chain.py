"""Where K7 (qstage), K8 (qstage_proj) and K9 (qivr) spend their cycles, on
the card: clock64 probes of both kernels of each.

    python -m qtpu_torch.ops.probe_chain [--out FILE] [--paths igemm,wgmma]
                                         [--batches 8,128] [--kernels K7,K8]

It builds ``csrc/qstage.cu``, ``csrc/qivr.cu`` (the older kernels: three
phases of ``igemm.cuh``'s ``mma.sync`` loop a chained block) and
``csrc/qstage_wg.cu``, ``csrc/qstage_proj_wg.cu``, ``csrc/qivr_wg.cu``
(the wgmma runner, ``csrc/wgmma_phase.cuh``) once more with
``-DQTPU_PHASE_PROBE -DQTPU_IGEMM_PROBE`` (libraries of their own; the
kernels every other caller loads carry no probe code) and runs the chained
engines' runs — K7 at ResNet-50's four identity runs, K8 at its whole
layer1 (the projection block, then 2 chained blocks), K9 at
MobileNet-v2's five — at each batch.  Thread 0 of every block sums its ``clock64()`` cycles by slot
(grid_phase.cuh: PhaseProbe), reported as the mean and the largest over
the blocks that ran a tile, with the block's total:

* the older kernels, per phase (conv1 / expand, conv2 / depthwise, conv3 /
  project): ``copy`` (issuing the cp.async copies and waiting for them),
  ``mma`` (the fragment loads and mma.sync; the whole depthwise loop for
  K9), ``epilogue`` (the byte-at-a-time requant and stores);
* the runner: phase A (conv1 / expand on K1's tile) ``a_wait_stage``,
  ``a_wgmma``, ``a_epilogue``; phase B (K5's tile or K9's depthwise +
  project tile) ``b_halo`` (K7: the halo's wait and zero-point fill; K9:
  the waits for halo stages), ``b_conv2`` (K7 conv2's wgmma loop; K9 the
  depthwise on CUDA cores), ``b_requant`` (K7 conv2's requant into
  ``mid``), ``b_wait_stage``, ``b_wgmma``, ``b_epilogue`` (conv3 /
  project); in the split mode ``split_conv2`` and ``split_conv3``, the
  second and third phases whole; ``producer_wait`` the producer thread's
  waits for a free stage;
* both: ``barrier`` (the waits at the grid barriers) and ``tiles`` (the
  tiles a block ran, over all phases);
* K8's projection block apart from its chain: the older kernel's
  ``p_conv1_*``, ``p_conv2_*``, ``p_conv3_*`` (``copy``, ``mma``,
  ``epilogue``; conv3's with the downsample's mainloop and dequant) and
  ``p_barrier``; the runner's ``p0`` (conv1), ``p1`` (conv2), ``p2``
  (conv3 + downsample) whole, ``p_barrier``, and P0's and P2's
  ``p_wait_stage``, ``p_wgmma``, ``p_epilogue``.

Each row also gives the kernel's device time by CUDA events (probe
launches) and checks its output against the plain version.  Cycles are SM
clocks (``clocks.sm`` under load, from ``nvidia-smi``).  ``--coop-cluster``
also asks the card whether a cooperative launch takes a cluster dimension.
Needs one CUDA device; nothing here runs on the CPU.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import sys
from pathlib import Path

import torch

from qtpu_torch.bench.timing import device_label
from qtpu_torch.ops import _build, qops
from qtpu_torch.ops import qivr as k9
from qtpu_torch.ops import qstage as k7
from qtpu_torch.ops.probe_k1 import _sm_mhz, check
from qtpu_torch.ops.probe_k2 import _events_ms

DEFINES = ("-DQTPU_PHASE_PROBE", "-DQTPU_IGEMM_PROBE")
SLOTS = 32
OLD = {"K7": ("conv1", "conv2", "conv3"), "K8": ("conv1", "conv2", "conv3"),
       "K9": ("expand", "dw", "project")}
# K8's own slots: the older kernel's projection phases from slot 18, the
# runner's from 16
OLD_PROJ = ["p_" + f"{ph}_{what}" for ph in ("conv1", "conv2", "conv3")
            for what in ("copy", "mma", "epilogue")] + ["p_barrier"]
NEW_PROJ = ("p0", "p1", "p2", "p_barrier", "p_wait_stage", "p_wgmma",
            "p_epilogue")
NEW = ("a_wait_stage", "a_wgmma", "a_epilogue", "b_halo", "b_conv2",
       "b_requant", "b_wait_stage", "b_wgmma", "b_epilogue", "barrier",
       "tiles", "split_conv2", "producer_wait", "split_conv3")
# the chained engines' runs: K7 (label, H, Cin, Cmid, blocks), K9 (label,
# H, C, E, blocks); K8 (label, H, (Cp, Cm, Co), chained blocks): the
# projection's Cm is the chain's Cmid
RUNS = {"K7": (("layer1", 56, 256, 64, 2), ("layer2", 28, 512, 128, 3),
               ("layer3", 14, 1024, 256, 5), ("layer4", 7, 2048, 512, 2)),
        "K8": (("layer1 stage", 56, (64, 64, 256), 64, 2),),
        "K9": (("block2", 56, 24, 144, 1), ("block4-5", 28, 32, 192, 2),
               ("block7-9", 14, 64, 384, 3), ("block11-12", 14, 96, 576, 2),
               ("block14-15", 7, 160, 960, 2))}
_LIBS = {("K7", "igemm"): "qstage", ("K7", "wgmma"): "qstage_wg",
         ("K8", "igemm"): "qstage", ("K8", "wgmma"): "qstage_proj_wg",
         ("K9", "igemm"): "qivr", ("K9", "wgmma"): "qivr_wg"}


def _coeffs(n, k, g, dev, **kw):
    return qops.epilogue_coeffs(
        act_scale=0.02, act_zp=-9,
        w_scale=(torch.rand(n, generator=g) * 0.01 + 1e-3).to(dev),
        colsum=torch.randint(-127 * k // 8, 127 * k // 8, (n,), generator=g,
                             dtype=torch.int32).to(dev),
        bias=torch.randn(n, generator=g).to(dev), **kw)


def chain_case(kind, B, H, c, cm, n, g, dev, zp=-9):
    """(x, w1, w2 or wd, w3, ChainCoeffs) of a K7 or K9 run on random codes
    with ``chip_smoke.py``'s requant coefficients; for K8 (``c`` = (Cp, Cm,
    Co), ``cm`` the chain's Cmid) (x, wp1, wp2, wp3, wd, pco, cod, w1, w2,
    w3, co), :func:`qtpu_torch.ops.qstage.qstage_proj_folded`'s
    operands."""
    def i8(*shape, lo=-128):
        return torch.randint(lo, 128, shape, generator=g,
                             dtype=torch.int8).to(dev)
    req = dict(requant_scale=0.05, requant_zp=-20, relu=True)
    if kind == "K8":
        cp_, cmp_, co = c
        _, *chain = chain_case("K7", B, H, co, cm, n, g, dev, zp)
        pco = k7.stack_chain([(_coeffs(cmp_, cp_, g, dev, **req),
                               _coeffs(cmp_, 9 * cmp_, g, dev, **req),
                               _coeffs(co, cmp_, g, dev, res_f32=True, **req),
                               zp)])
        cod, _ = _coeffs(co, cp_, g, dev)
        return (i8(B, H, H, cp_), i8(cmp_, cp_, lo=-127),
                i8(cmp_, 9 * cmp_, lo=-127), i8(co, cmp_, lo=-127),
                i8(co, cp_, lo=-127), pco, cod, *chain)
    if kind == "K7":
        blocks = [(_coeffs(cm, c, g, dev, **req),
                   _coeffs(cm, 9 * cm, g, dev, **req),
                   _coeffs(c, cm, g, dev, res_scale=0.04, res_zp=-7, **req),
                   zp) for _ in range(n)]
        w = (i8(n, cm, c, lo=-127), i8(n, cm, 9 * cm, lo=-127),
             i8(n, c, cm, lo=-127))
    else:
        r6 = dict(relu=True, act_max=6.0, requant_scale=0.05,
                  requant_zp=-128)
        blocks = [(_coeffs(cm, c, g, dev, **r6), _coeffs(cm, 9, g, dev, **r6),
                   _coeffs(c, cm, g, dev, requant_scale=0.05, requant_zp=-20,
                           res_scale=0.04, res_zp=-7), zp)
                  for _ in range(n)]
        w = (i8(n, cm, c, lo=-127), i8(n, 9, cm, lo=-127),
             i8(n, c, cm, lo=-127))
    return (i8(B, H, H, c), *w, k7.stack_chain(blocks))


def probe_row(kind, label, B, H, c, cm, n, g, dev, paths):
    fn, plain = {"K7": (k7.qstage_folded, k7.qstage_folded_plain),
                 "K8": (k7.qstage_proj_folded, k7.qstage_proj_folded_plain),
                 "K9": (k9.qivr_folded, k9.qivr_folded_plain)}[kind]
    args = chain_case(kind, B, H, c, cm, n, g, dev)
    ref = plain(*args)
    row = dict(kernel=kind, label=label, B=B, H=H, C=c, Cm=cm, blocks=n)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    # the older kernels' resident grids hold many blocks an SM
    buf = torch.zeros((64 * sms, SLOTS), dtype=torch.int64, device=dev)
    for path in paths:
        setp = _build.load(_LIBS[(kind, path)], "qtpu_phase_probe_set",
                           (ctypes.c_void_p,), DEFINES)
        check(setp(buf.data_ptr()), "qtpu_phase_probe_set")

        def launch():
            return fn(*args, path=path, defines=DEFINES)
        row[f"{path}_ms"] = _events_ms(launch)
        buf.zero_()
        out = launch()
        torch.cuda.synchronize()
        check(torch.equal(out, ref), f"{kind} {label} B={B} ({path}): "
              "differs from plain")
        st = buf.cpu()
        used = st[st[:, 10] > 0].double()
        row[f"{path}_blocks"] = int(len(used))
        row[f"{path}_block_cycles"] = float(used[:, SLOTS - 1].mean())
        if path == "igemm":
            names = [f"{ph}_{what}" for ph in OLD[kind]
                     for what in ("copy", "mma", "epilogue")]
            names += ["barrier", "tiles"]
            extra = OLD_PROJ if kind == "K8" else ()
            first = 18
        else:
            names = list(NEW)
            extra = NEW_PROJ if kind == "K8" else ()
            first = 16
        slots = list(enumerate(names)) + [(first + i, nm)
                                          for i, nm in enumerate(extra)]
        for i, name in slots:
            row[f"{path}_{name}_cycles"] = float(used[:, i].mean())
            row[f"{path}_{name}_max"] = float(used[:, i].max())
    return row


def coop_cluster(dev) -> dict:
    """Whether the card takes a cooperative launch with a cluster
    dimension (2 and 4 blocks a cluster), from a trivial kernel."""
    fn = _build.load("qstage", "qtpu_probe_coop_cluster",
                     (ctypes.c_void_p, ctypes.c_int, ctypes.c_int), DEFINES)
    out = torch.full((8,), -1, dtype=torch.int32, device=dev)
    res = {}
    for cs in (1, 2, 4):
        out.fill_(-1)
        err = fn(out.data_ptr(), 8, cs)
        if not err:
            torch.cuda.synchronize()
        res[f"cs{cs}"] = dict(error=int(err), ranks=out.cpu().tolist())
    return res


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", help="also write the rows as JSON here")
    p.add_argument("--paths", default="igemm,wgmma",
                   help="the kernels to probe, of igemm,wgmma")
    p.add_argument("--batches", default="8,128")
    p.add_argument("--kernels", default="K7,K8,K9",
                   help="the rows to probe, of K7,K8,K9")
    p.add_argument("--coop-cluster", action="store_true",
                   help="also try a cooperative launch with clusters")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("probe_chain: needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    card = device_label(dev)
    print(card, flush=True)
    paths = [q for q in args.paths.split(",") if q]
    if not paths or any(q not in ("igemm", "wgmma") for q in paths):
        p.error("--paths takes some of igemm,wgmma")
    kernels = [k for k in args.kernels.split(",") if k]
    if not kernels or any(k not in RUNS for k in kernels):
        p.error("--kernels takes some of K7,K8,K9")
    _build.build(sorted({_LIBS[(k, q)] for k in kernels for q in paths}
                        | ({"qstage"} if args.coop_cluster else set())),
                 DEFINES)
    result = {"card": card, "rows": []}
    if args.coop_cluster:
        result["coop_cluster"] = coop_cluster(dev)
        print(json.dumps(result["coop_cluster"]), flush=True)
    g = torch.Generator().manual_seed(0)
    for B in (int(b) for b in args.batches.split(",")):
        for kind in kernels:
            for label, H, c, cm, n in RUNS[kind]:
                row = probe_row(kind, label, B, H, c, cm, n, g, dev, paths)
                row["sm_mhz"] = _sm_mhz()
                result["rows"].append(row)
                print(json.dumps(row), flush=True)
                torch.cuda.empty_cache()
    if args.out:
        out = Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
